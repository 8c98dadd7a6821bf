#!/usr/bin/env python3
"""Drive the PyTorch port (mo_renderer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

0. Environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions.
1. Build: compile the CUDA kernels from csrc/ with nvcc (one process per
   source, all at once).
2. Kernels: capture each kernel's inputs from one 1920x1080 frame of the
   asset-free scene on each of the port's four paths (default, reference
   sampling, megakernel, and the texture-stack path on the scene's
   all-slots variant), then hold every CUDA kernel against its plain
   PyTorch version on those same card tensors, and time both: the median
   over 20 calls of the device time between two CUDA events, with each
   call queued behind a sleep kernel so the host's issue time is not in
   the measurement.  Each kernel's bound is the larger of the bytes it
   must move over 3.35 TB/s and its FP32 operations over 67 TFLOP/s
   (the H100 SXM data sheet), both counted from this run's inputs.
3. Frames at 256x128: the default frame, the reference-path frame
   (fast_sampling=False), the UV1 scene under default flags, the
   megakernel frame (raster_interp_attrs=True, ssao_res_divisor=1), the
   texture-stack frames (stack kernel on, attrs kernel off or on) and
   the frame under each other fast-path option (the two other PCF
   layouts, the specular taps at full rate or unmerged, SSAO without the
   tile kernel), each on the card against the port's CPU frame of the
   same scene, within the golden bar of tests/test_golden.py (mean
   |diff| < 2/255, < 0.5% of channels > 16/255).  The stack kernel must
   launch on the texture-stack frames and nowhere else, also when the
   reference and megakernel paths are given stack_plane_kernel=True.
4. Frames at 1920x1080 through the port's App.run along the reference
   benchmark's small camera orbit, on each of the four paths (the
   texture-stack path on the all-slots scene): finite, not black, sky
   and geometry both present, no bin overflow, and every kernel of the
   path launched during its run (the counts are set to 0 just before each
   path and read just after; the reference path re-rasterizes the shadow
   map every frame).  Prints each path's steady-state ms/frame, then its
   kernel launches and device kernel time per frame from torch.profiler
   over two more frames.

The last two lines are a JSON summary of the kernels and the contract
line {"ok": true, "device": {...}}.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# kernel name -> (csrc file, TPU kernel it replaces)
KERNELS = {
    "raster_slim": ("mo_renderer_tpu_torch/csrc/raster.cu",
                    "mo_renderer_tpu/kernels/rasterizer.py:549"),
    "raster_depth": ("mo_renderer_tpu_torch/csrc/raster.cu",
                     "mo_renderer_tpu/kernels/rasterizer.py:549"),
    "attr_planes": ("mo_renderer_tpu_torch/csrc/attr_planes.cu",
                    "mo_renderer_tpu/kernels/attr_planes.py:124"),
    "ssao": ("mo_renderer_tpu_torch/csrc/ssao.cu",
             "mo_renderer_tpu/passes/ssao.py:171"),
    "interleave": ("mo_renderer_tpu_torch/csrc/interleave.cu",
                   "mo_renderer_tpu/kernels/decimate.py:98"),
    "raster_full": ("mo_renderer_tpu_torch/csrc/raster.cu",
                    "mo_renderer_tpu/kernels/rasterizer.py:549"),
    "raster_attrs": ("mo_renderer_tpu_torch/csrc/raster_attrs.cu",
                     "mo_renderer_tpu/kernels/rasterizer.py:288"),
    "stack_planes": ("mo_renderer_tpu_torch/csrc/stack_planes.cu",
                     "mo_renderer_tpu/kernels/stack_planes.py:66"),
}

STACKS = {"attrs_plane_kernel": False, "stack_plane_kernel": True}

# the port's four paths: EngineConfig overrides, the kernels each runs,
# and the scene variant (scenes.tiny_world keywords)
PATHS = {
    "default": ({}, ("raster_slim", "raster_depth", "attr_planes", "ssao",
                     "interleave"), {}),
    "reference": ({"fast_sampling": False},
                  ("raster_full", "raster_depth", "ssao"), {}),
    "megakernel": ({"raster_interp_attrs": True},
                   ("raster_attrs", "raster_depth", "ssao"), {}),
    "stacks": (STACKS, ("raster_slim", "raster_depth", "stack_planes",
                        "ssao", "interleave"), {"all_slots": True}),
}

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12  # outside the tensor cores

# FP32 operations per unit of work, counted from the kernels' arithmetic
# (multiplies, adds and square roots; an FMA counts two; compares,
# selects and integer work not counted)
RASTER_FLOPS_PER_CANDIDATE = 16  # 3 edges x 4 + the fused depth plane
FULL_FLOPS_PER_PIXEL = 8  # two fused edges and two products, per pixel
ATTRS_FLOPS_PER_PIXEL = 95  # q, qs, 1/qs, 14 channels x 5
ATTR_PLANES_FLOPS_PER_PIXEL = 50
SSAO_FLOPS_PER_TAP = 10
STACK_FLOPS_PER_PIXEL = 6  # the four bilinear weights
STACK_FLOPS_PER_PLANE = 11  # 4 scales by 1/255, 4 weights, 3 adds


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def median_ms(fn, runs=20, sleep_cycles=50_000_000):
    """Median device ms of one call of ``fn``: the call is issued while
    the stream still runs a ~30 ms sleep kernel, so the events bracket
    device work only, not the host's time to issue it."""
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(n_bytes, n_flops):
    """(bound_ms, bound_by): the least time for the bytes and the FP32
    operations at the card's published peaks."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def capture_inputs(cfg, device):
    """Run one frame on each path and record what each kernel wrapper got
    (the first call per kernel).  Returns {kernel: (args, kwargs)}."""
    import mo_renderer_tpu_torch.passes.frame_graph as FG
    import mo_renderer_tpu_torch.passes.gbuffer as GB
    from mo_renderer_tpu_torch import Renderer, scenes

    seen = {}
    originals = {
        (FG, "rasterize"): FG.rasterize,
        (FG, "rasterize_attrs"): FG.rasterize_attrs,
        (GB, "attr_planes"): GB.attr_planes,
        (FG, "ssao_pass_tiles"): FG.ssao_pass_tiles,
        (FG, "reconstruct_full"): FG.reconstruct_full,
        (GB, "stack_planes"): GB.stack_planes,
    }

    def recorder(key, fn):
        def wrapped(*args, **kw):
            name = key
            if key == "raster":
                name = ("raster_depth" if kw.get("depth_only") else
                        "raster_slim" if kw.get("slim") else "raster_full")
            seen.setdefault(name, (args, kw))
            return fn(*args, **kw)
        return wrapped

    FG.rasterize = recorder("raster", originals[(FG, "rasterize")])
    FG.rasterize_attrs = recorder(
        "raster_attrs", originals[(FG, "rasterize_attrs")])
    GB.attr_planes = recorder("attr_planes", originals[(GB, "attr_planes")])
    FG.ssao_pass_tiles = recorder(
        "ssao", originals[(FG, "ssao_pass_tiles")])
    FG.reconstruct_full = recorder(
        "interleave", originals[(FG, "reconstruct_full")])
    GB.stack_planes = recorder(
        "stack_planes", originals[(GB, "stack_planes")])
    try:
        for overrides, _, scene_kw in PATHS.values():
            pcfg = dataclasses.replace(cfg, **overrides)
            world = scenes.tiny_world(**scene_kw)
            world.insert_resource(scenes.camera(pcfg))
            renderer = Renderer(pcfg, device)
            renderer.prepare(world)
            renderer.render(world)
    finally:
        for (mod, attr), fn in originals.items():
            setattr(mod, attr, fn)
    missing = set(KERNELS) - set(seen)
    if missing:
        raise RuntimeError(f"the frames never called {sorted(missing)}")
    return seen


def check_kernels(cfg, device):
    """Phase 2: each CUDA kernel against its plain version on the card."""
    import torch

    from mo_renderer_tpu_torch.kernels import attr_planes as AP
    from mo_renderer_tpu_torch.kernels import rasterizer as R
    from mo_renderer_tpu_torch.kernels import stack_planes as SP
    from mo_renderer_tpu_torch.passes import checkerboard as CB
    from mo_renderer_tpu_torch.passes import ssao as S

    seen = capture_inputs(cfg, device)
    results = {}

    def bytes_of(x):
        return x.contiguous().view(torch.uint8).to(torch.int32)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def exact(a, b):
        return (a.double() - b.double()).abs().max().item()

    def raster_inputs(binned):
        return nbytes(binned.tri_data, binned.pair_tri, binned.tile_start,
                      binned.tile_count)

    def candidates(binned):
        return binned.pair_tri.shape[0] * binned.tile_h * binned.tile_w

    # each case: (kernel, plain, comparison -> (max_abs_err, ok, bar),
    # shape, bytes moved, FP32 operations)
    def raster(mode):
        (binned,), kw = seen[f"raster_{mode}"]
        w, h = kw["width"], kw["height"]
        shape = f"{h}x{w}, {binned.pair_tri.shape[0]} pairs"
        n_out = {"depth": 1, "slim": 2, "full": 4}[mode]
        flops = candidates(binned) * RASTER_FLOPS_PER_CANDIDATE
        if mode == "full":
            flops += FULL_FLOPS_PER_PIXEL * w * h

        def cmp(k, p):
            err = exact(k[1], p[1])
            ok = err == 0.0
            if mode != "depth":
                ok = ok and bool(torch.equal(k[0], p[0]))
            if mode == "full":
                err = max(err, exact(k[2], p[2]), exact(k[3], p[3]))
                ok = ok and err <= 1e-6
            bar = {"depth": "depth exact", "slim": "ids and depth exact",
                   "full": "ids and depth exact, b0/b1 atol 1e-6"}[mode]
            return err, ok, bar
        return (
            lambda: R._raster_cuda(binned, w, h, mode),
            lambda: R._raster_plain(binned, w, h, mode),
            cmp, shape, raster_inputs(binned) + n_out * 4 * w * h, flops,
        )

    def raster_attrs():
        (binned,), kw = seen["raster_attrs"]
        w, h = kw["width"], kw["height"]

        def cmp(k, p):
            ids = torch.equal(k[0], p[0])
            flat = torch.equal(k[2][R.N_INTERP:], p[2][R.N_INTERP:])
            z_err = exact(k[1], p[1])
            err = max(z_err, exact(k[2][:R.N_INTERP], p[2][:R.N_INTERP]))
            close = bool(torch.allclose(k[2], p[2], rtol=2e-3, atol=1e-4))
            return err, ids and flat and z_err <= 1e-6 and close, (
                "ids, mat, handedness exact; z atol 1e-6; "
                "planes rtol 2e-3 / atol 1e-4")
        covered = None

        def plain():
            nonlocal covered
            out = R._raster_attrs_plain(binned, w, h)
            covered = int((out[0] >= 0).sum())
            return out
        out = plain()
        flops = (candidates(binned) * RASTER_FLOPS_PER_CANDIDATE
                 + ATTRS_FLOPS_PER_PIXEL * covered)
        return (
            lambda: R._raster_attrs_cuda(binned, w, h), plain, cmp,
            f"{h}x{w}, {binned.pair_tri.shape[0]} pairs, "
            f"{binned.tri_data.shape[1]}-float rows -> {out[2].shape[0]} "
            "planes",
            raster_inputs(binned) + (2 + out[2].shape[0]) * 4 * w * h, flops,
        )

    def attr():
        (tri, attrs, pv), kw = seen["attr_planes"]
        args = (tri, attrs, pv, kw["n_mat"], kw["full_wh"], kw["cb"], 0)
        n_out = AP.n_planes(kw["n_mat"])

        def cmp(k, p):
            err = (k - p).abs().max().item()
            ok = bool(torch.allclose(k, p, rtol=2e-3, atol=1e-4,
                                     equal_nan=True))
            return err, ok, "rtol 2e-3 / atol 1e-4"
        return (
            lambda: AP._attr_planes_cuda(*args),
            lambda: AP._attr_planes_plain(*args),
            cmp, f"{tuple(tri.shape)} -> {n_out} planes",
            nbytes(tri, attrs, pv) + n_out * 4 * tri.numel(),
            ATTR_PLANES_FLOPS_PER_PIXEL * tri.numel(),
        )

    def ssao():
        (depth,), kw = seen["ssao"]
        args = (depth, S.NUM_LEVELS, 0, kw["near"], kw["far"])
        n_taps = max(len(t) for t in S._ssao_tap_table(
            depth.shape[1], S.NUM_LEVELS)[1])

        def cmp(k, p):
            err = (k - p).abs().max().item()
            frac = (k != p).float().mean().item()
            return err, err <= 1.01 / 255 and frac < 0.002, (
                f"<= 1.01/255 on < 0.2% of pixels ({frac:.5%} differ)")
        return (
            lambda: S._ssao_cuda(*args), lambda: S._ssao_plain(*args),
            cmp, f"{tuple(depth.shape)}", 2 * nbytes(depth),
            SSAO_FLOPS_PER_TAP * n_taps * depth.numel(),
        )

    def interleave():
        (cb, tri), _ = seen["interleave"]

        def cmp(k, p):
            err = (bytes_of(k) - bytes_of(p)).abs().max().item()
            return err, err == 0, "exact"
        return (
            lambda: CB._reconstruct_cuda(cb, tri),
            lambda: CB._reconstruct_plain(cb, tri),
            cmp, f"{tuple(cb.shape)} -> {tuple(tri.shape)}",
            nbytes(cb, tri, tri), 0,
        )

    def stack():
        (idx, fx, fy, groups, spec), _ = seen["stack_planes"]
        args = (idx, fx, fy, groups, spec)
        widths = "/".join(str(g.shape[1]) for g in groups)

        def cmp(k, p):
            err = exact(k, p)
            return err, err <= 1e-6, "exact expected, atol 1e-6"
        # each input read once (the group tables whole), each plane
        # written once
        return (
            lambda: SP._stack_planes_cuda(*args),
            lambda: SP._stack_planes_plain(*args),
            cmp, f"{tuple(idx.shape)}, groups {widths} wide "
            f"({groups[0].shape[0]} rows) -> {len(spec)} planes",
            nbytes(idx, fx, fy, *groups) + len(spec) * 4 * idx.numel(),
            (STACK_FLOPS_PER_PIXEL + STACK_FLOPS_PER_PLANE * len(spec))
            * idx.numel(),
        )

    cases = {
        "raster_slim": raster("slim"), "raster_depth": raster("depth"),
        "attr_planes": attr(), "ssao": ssao(), "interleave": interleave(),
        "raster_full": raster("full"), "raster_attrs": raster_attrs(),
        "stack_planes": stack(),
    }
    for name, (kern, plain, cmp, shape, n_bytes, n_flops) in cases.items():
        k_out, p_out = kern(), plain()
        torch.cuda.synchronize()
        err, ok, bar = cmp(k_out, p_out)
        ms = median_ms(kern)
        plain_ms = median_ms(plain)
        bound_ms, bound_by = bound(n_bytes, n_flops)
        print(f"[2] {name:13s} {shape}: max |err| {err:.3g} ({bar}) "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} ({n_bytes / 1e6:.2f} MB, "
              f"{n_flops / 1e6:.1f} MFLOP)", flush=True)
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max |err| {err}, bar: {bar})")
        results[name] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes any of these functions
            "library_ms": None,
        }
    return results


def check_small_frames(device):
    """Phase 3: the 256x128 frames on the card vs on the CPU; the stack
    kernel launches on the card exactly where the config and the path
    call for it."""
    import numpy as np

    from mo_renderer_tpu_torch import Renderer, scenes
    from mo_renderer_tpu_torch.kernels import _build

    stack_on = {"stack_plane_kernel": True}
    # what -> (overrides, scene variant, the stack kernel runs)
    cases = {
        "default": ({}, {}, False),
        "reference path": ({"fast_sampling": False}, {}, False),
        "UV1 scene": ({}, {"uv1": True}, False),
        "megakernel": ({"raster_interp_attrs": True,
                        "ssao_res_divisor": 1}, {}, False),
        "texture-stack": (STACKS, {"all_slots": True}, True),
        "both plane kernels": ({"attrs_plane_kernel": True, **stack_on},
                               {"all_slots": True}, True),
        "reference path, stack kernel on": (
            {"fast_sampling": False, **stack_on}, {"all_slots": True},
            False),
        "megakernel, stack kernel on": (
            {"raster_interp_attrs": True, "ssao_res_divisor": 1, **stack_on},
            {"all_slots": True}, False),
        "pcf_u16=False": ({"pcf_u16": False}, {}, False),
        "pcf_half_anchor=False": ({"pcf_half_anchor": False}, {}, False),
        "spec_parent_mip_half_res=False": (
            {"spec_parent_mip_half_res": False}, {}, False),
        "spec_merged_trilinear=False": (
            {"spec_merged_trilinear": False}, {}, False),
        "spec_mirror_half_res=False, checkerboard=False": (
            {"spec_mirror_half_res": False, "checkerboard": False}, {},
            False),
        "ssao_pallas=False": ({"ssao_pallas": False}, {}, False),
    }
    for what, (overrides, scene_kw, k7) in cases.items():
        frames = []
        for dev in (device, "cpu"):
            cfg = scenes.tiny_config(**overrides)
            world = scenes.tiny_world(**scene_kw)
            world.insert_resource(scenes.camera(cfg))
            r = Renderer(cfg, dev)
            r.prepare(world)
            before = _build.LAUNCHES["stack_planes"]
            frames.append(r.render(world).astype(np.int32))
            launched = _build.LAUNCHES["stack_planes"] > before
            if launched != (k7 and dev == device):
                raise AssertionError(
                    f"256x128 {what} frame on {dev}: the stack kernel "
                    f"{'launched' if launched else 'did not launch'}")
        gpu, cpu = frames
        if gpu.shape != (128, 256, 4):
            raise AssertionError(f"256x128 frame has shape {gpu.shape}")
        diff = np.abs(gpu - cpu)[..., :3]
        mean, big = diff.mean(), (diff > 16).mean()
        print(f"[3] 256x128 {what} frame, card vs CPU: max |diff| "
              f"{diff.max()} LSB, mean {mean:.4f} LSB, {big:.4%} of "
              "channels > 16 (bar: mean < 2, < 0.5%)", flush=True)
        if not (mean < 2.0 and big < 0.005):
            raise AssertionError(f"256x128 {what} card frame misses the "
                                 "golden bar")


def profile_frames(app, n_frames=2):
    """torch.profiler over ``n_frames`` frames of ``app``: (kernel
    launches per frame, device kernel ms per frame)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        app.run(num_frames=n_frames)
        torch.cuda.synchronize()
    launches, device_us = 0, 0.0
    for row in prof.key_averages():
        if row.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += row.count
        # only the device's own rows (kernels, copies): an op's row and
        # its runtime launch's row repeat the same kernel time
        if row.device_type == torch.autograd.DeviceType.CUDA:
            device_us += row.self_device_time_total
    return launches / n_frames, device_us / 1e3 / n_frames


def run_full_frame(device, line, path, n_frames, warmup=3):
    """Phase 4: one path's 1080p frame through App.run."""
    import numpy as np
    import torch

    from mo_renderer_tpu_torch import App, scenes
    from mo_renderer_tpu_torch.config import EngineConfig
    from mo_renderer_tpu_torch.kernels import _build

    overrides, kernels, scene_kw = PATHS[path]
    cfg = EngineConfig(width=1920, height=1080, **overrides)
    app = App.new(config=cfg, device=device)
    app.world = scenes.tiny_world(**scene_kw)
    app.insert_resource(scenes.camera(cfg))
    app.add_runtime_system(scenes.orbit_system(warmup + n_frames))
    app.resumed()

    _build.reset_launches()
    app.run(num_frames=warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame = app.run(num_frames=n_frames)  # render() syncs every frame
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n_frames
    counts = dict(_build.LAUNCHES)
    app.renderer.check_overflow()
    launches, device_ms = profile_frames(app)

    rgb = frame[..., :3]
    covered = _covered_fraction(app.renderer, app.world, cfg)
    print(f"[4] {path} 1920x1080 frame: shape {frame.shape}, max "
          f"{rgb.max()}, mean {rgb.mean():.2f}, covered fraction "
          f"{covered:.4f}, launches over {warmup + n_frames} frames "
          f"{counts}", flush=True)
    print(f"[4] {path} steady state: {ms:.3f} ms/frame over {n_frames} "
          f"frames (App.run, host fetch each frame) on {line}", flush=True)
    print(f"[4] {path} profile (2 frames, torch.profiler): {launches:.0f} "
          f"kernel launches/frame, {device_ms:.3f} ms/frame of device "
          f"kernel time ({device_ms / ms:.1%} of the unprofiled frame)",
          flush=True)
    if frame.shape != (1080, 1920, 4) or frame.dtype != np.uint8:
        raise AssertionError(f"frame {frame.shape} {frame.dtype}")
    if rgb.max() == 0:
        raise AssertionError("black frame")
    if not 0.0 < covered < 1.0:
        raise AssertionError(f"covered fraction {covered}: need sky and "
                             "geometry")
    idle = [k for k in kernels if counts[k] == 0]
    if idle:
        raise AssertionError(f"{path}: kernels never launched: {idle}")
    stray = [k for k, v in counts.items() if v and k not in kernels]
    if stray:
        raise AssertionError(f"{path}: launched kernels of other paths: "
                             f"{stray}")
    if path == "reference" and counts["raster_depth"] != warmup + n_frames:
        raise AssertionError("the reference path must re-raster the shadow "
                             "map every frame")
    return counts, ms


def _covered_fraction(renderer, world, cfg):
    """Share of the frame's pixels covered by geometry (depth < 1)."""
    from mo_renderer_tpu_torch.kernels.raster_setup import (
        triangle_setup_from_attrs,
    )
    from mo_renderer_tpu_torch.kernels.rasterizer import rasterize
    from mo_renderer_tpu_torch.passes.frame_graph import _bin

    params, _ = renderer.frame_params(world)
    setup = triangle_setup_from_attrs(
        renderer.scene.tri_attrs, renderer.scene.tri_valid,
        params["proj_view"], renderer.pad_w, renderer.pad_h,
    )
    tri, _, _, _ = rasterize(_bin(setup, renderer.pad_w, renderer.pad_h,
                                  None),
                             width=renderer.pad_w, height=renderer.pad_h,
                             slim=True)
    return (tri[: cfg.height, : cfg.width] >= 0).float().mean().item()


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "mo_renderer_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(mo_renderer_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs the port on a card",
              file=sys.stderr)
        return 1
    device = "cuda"
    line = card_line()
    print(f"[0] {line}", flush=True)
    print(f"[0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from mo_renderer_tpu_torch.config import EngineConfig
    from mo_renderer_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"[1] built {len(_build.sources())} CUDA sources in "
          f"{_build.build_seconds:.1f} s (load {time.perf_counter() - t0:.1f}"
          f" s total)", flush=True)

    kernels = check_kernels(EngineConfig(width=1920, height=1080), device)
    check_small_frames(device)
    launches = {name: {} for name in KERNELS}
    for path, n_frames in (("default", 16), ("reference", 8),
                           ("megakernel", 8), ("stacks", 8)):
        counts, _ = run_full_frame(device, line, path, n_frames)
        for name in PATHS[path][1]:
            launches[name][path] = counts[name]

    summary = {"kernels": [
        {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(launches[name].values()),
            "launches_by_path": launches[name], **kernels[name],
        }
        for name, (src, rep) in KERNELS.items()
    ]}
    print(json.dumps(summary))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
