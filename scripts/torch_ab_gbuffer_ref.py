#!/usr/bin/env python3
"""Time the reference path's G-buffer kernel K12 (csrc/gbuffer_ref.cu) of
several checkouts on the same inputs, in turns, on one card.

    python3 scripts/torch_ab_gbuffer_ref.py CHECKOUT [CHECKOUT ...] \
        [--rounds N]

Run from the root of a checkout (whose package and chip_smoke.py capture
the inputs) with the others unpacked into gitignored directories, e.g.
``git archive <parent> | tar -x -C _scratch/parent``; ``.`` names this
one.  Each checkout's library is built by its own kernels/_build.py
(loaded by path: it builds its own csrc/ with its own flags into its own
_build/) and loaded in this process, and K12 is launched from it through
this checkout's wrapper (passes/gbuffer.py ``_gbuffer_ref_cuda``), so each
checkout's GbufRefArgs must have this one's layout: a checkout whose
``mo_gbuffer_ref_args_size`` differs is named and the script exits 1
before any launch.  The calls: the reference path's 1920x1080 call on
the tiny scene (``tiny``), on scenes.grid_world(10) (``grid``) and on
that scene from scenes.lit_camera (``lit``, no sky pixel); and, checked
but not timed, the ``lit`` call cut to an odd 1079x1917 target
(``lit_edge``, chip_smoke.edge_cut).

Prints the card's name and power limit; each checkout's registers and
SASS mix of each gbuffer_ref_kernel instance (chip_smoke.sass_report);
each checkout's check on each call (chip_smoke.gbuffer_ref_check: every
plane at GBUFFER_REF_BAR, the mask equal, the texel anchors and UV sets
apart through the debug output); then per call and round the median
device ms of 20 launches of each checkout (chip_smoke.median_ms), the
checkouts in order and then in reverse; and last one JSON line {call:
{checkout: [ms, ...]}}.  Exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def checkout_library(path: str, tag: str):
    """(shared library path, loaded library) of ``path``'s kernels, built
    by that checkout's own kernels/_build.py."""
    spec = importlib.util.spec_from_file_location(
        f"_build_{tag}",
        os.path.join(path, "mo_renderer_tpu_torch", "kernels", "_build.py"))
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    so = build.build()
    lib = ctypes.CDLL(so)
    lib.mo_error_string.restype = ctypes.c_char_p
    lib.mo_error_string.argtypes = [ctypes.c_int]
    return so, lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    opt = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as C
    from mo_renderer_tpu_torch import scenes
    from mo_renderer_tpu_torch.config import EngineConfig
    from mo_renderer_tpu_torch.kernels import _build
    from mo_renderer_tpu_torch.passes import gbuffer as GB

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = {}
    for i, path in enumerate(opt.checkouts):
        so, libs[path] = checkout_library(os.path.abspath(path), str(i))
        size = libs[path].mo_gbuffer_ref_args_size()
        if size != ctypes.sizeof(GB.GbufRefArgs):
            print(f"{path}: its GbufRefArgs is {size} bytes, this "
                  f"checkout's {ctypes.sizeof(GB.GbufRefArgs)}: this "
                  "wrapper cannot launch it", file=sys.stderr)
            return 1
        for kernel, sass in sorted(C.sass_report(so, instances=True).items()):
            if kernel.startswith("gbuffer_ref_kernel"):
                print(f"{path}: {kernel} {json.dumps(sass)}", flush=True)

    cfg = EngineConfig(width=1920, height=1080)
    ref = C.PATHS["reference"][0]
    frames = {"tiny": (scenes.tiny_world, scenes.camera),
              "grid": (scenes.grid_world, scenes.grid_camera),
              "lit": (scenes.grid_world, scenes.lit_camera)}
    calls = {}
    for name, (world, camera) in frames.items():
        seen = C.capture_inputs(cfg, "cuda", [(ref, world, camera)],
                                {"gbuffer_ref"})
        calls[name] = seen["gbuffer_ref"][0]
    checked = {**calls, "lit_edge": C.edge_cut(calls["lit"])}
    for name, args in checked.items():
        tri = args[0]
        print(f"{name}: {tuple(tri.shape)}, {int((tri < 0).sum())} sky "
              f"pixels, {int(torch.unique(tri[tri >= 0]).numel())} "
              "triangles", flush=True)

    def use(path):
        _build._lib = libs[path]

    failed = False
    for name, args in checked.items():
        for path in opt.checkouts:
            use(path)
            err, ok, bar, apart = C.gbuffer_ref_check(args)
            print(f"check {name} {path}: max |err| {err:.3g}, ok {ok}, "
                  f"apart {apart}", flush=True)
            failed |= not ok
    times = {name: {path: [] for path in opt.checkouts} for name in calls}
    for r in range(opt.rounds):
        for name, args in calls.items():
            kernel = functools.partial(GB._gbuffer_ref_cuda, *args)
            for path in opt.checkouts + opt.checkouts[::-1]:
                use(path)
                times[name][path].append(C.median_ms(kernel))
            print(f"round {r} {name}: " + "; ".join(
                f"{p} {', '.join(f'{t:.4f}' for t in times[name][p][-2:])}"
                for p in opt.checkouts), flush=True)
    print(json.dumps(times))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
