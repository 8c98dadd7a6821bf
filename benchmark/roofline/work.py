"""Peaks and work counts, frozen copies of chip_smoke.py's ``bound``,
``shading_work``, ``gbuffer_work`` and the counts of the attribute-plane
kernel (K3), computed here from the plain reference's own calls.

A pass's work counts its inputs read once, its outputs written once, and
of gathered tables the rows this frame reads (the unique indices, which
the reference's helpers recompute).  ``probe`` renders a reference frame
and records the calls of the fast path's G-buffer (``attr_planes``,
``gbuffer_tail``) and shading (``shading_pass_fast``) to count them."""

from __future__ import annotations

import inspect

import torch

from ..harness.trace import patched
from ..reference.plain.assets import materials as M
from ..reference.plain.kernels import attr_planes as AP
from ..reference.plain.passes import frame_graph as FG
from ..reference.plain.passes import gbuffer as GB
from ..reference.plain.passes import shading as Sh

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, 700 W
FP32_FLOPS_PER_S = 67e12  # outside the tensor cores

ATTR_PLANES_FLOPS_PER_PIXEL = 50
GBUFFER_FLOPS_PER_PIXEL = 270  # velocity, texel anchor, 11 channels, TBN
N_GEO = 15  # K10's geometry channels: wp, n, t, bt, uv0, handedness
SLOT_CHANNELS = ((0, 1, 2), (0, 1, 2), (1, 2), (0,), (0, 1, 2))
SHADE_FLOPS_PER_PIXEL = 45
SHADE_FLOPS_PER_LIGHT = 150
SHADE_IBL_FLOPS_PER_PIXEL = 950
SHADE_FLOPS_PER_SKY_PIXEL = 20
SHADE_FLOPS_PER_TAP = 80
SHADE_FLOPS_PER_PCF_SAMPLE = 280


def bound_ms(n_bytes, n_flops) -> float:
    """The least time for the bytes and the FP32 operations at the
    card's published peaks."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS_PER_S) * 1e3


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def attr_planes_work(args, kwargs):
    """(bytes, operations) of K3 on a recorded ``attr_planes`` call."""
    (tri, attrs, pv), n_mat = args[:3], kwargs["n_mat"]
    n_out = AP.n_planes(n_mat)
    return (_nbytes(tri, attrs, pv) + n_out * 4 * tri.numel(),
            ATTR_PLANES_FLOPS_PER_PIXEL * tri.numel())


def _tail_args(args, kwargs):
    b = inspect.signature(GB.gbuffer_tail).bind(*args, **kwargs)
    b.apply_defaults()
    tri, z, src, params, scene, slot_map, stack_kernel = b.arguments.values()
    return tri, z, src, scene, slot_map, stack_kernel


def _gbuffer_rows(tri, src, scene, slot_map, stack_kernel):
    none = torch.full_like(tri, -1)
    if stack_kernel or all(p < 0 for p in slot_map):
        return none
    used = M.fast_used_cols(slot_map)
    mat = src.mat_cols
    if mat is None:
        mat = scene.materials.index_select(
            1, GB._column_index(used, tri.device))[
                torch.round(src.mat_plane).to(torch.int64)]
    idx, _, _ = GB._stack_anchor(GB._vec(src.uv0),
                                 mat[..., used.index(M.MAT_STACK_BASE)],
                                 mat[..., used.index(M.MAT_STACK_SIZE)])
    return torch.where(tri >= 0, idx, none)


def gbuffer_tail_work(args, kwargs):
    """(bytes, operations) of K10 on a recorded ``gbuffer_tail`` call."""
    tri, _, src, scene, slot_map, stack_kernel = _tail_args(args, kwargs)
    n_px = tri.numel()
    covered = int((tri >= 0).sum())
    n_mat = len(M.fast_used_cols(slot_map))
    n_sampled = sum(1 for p in slot_map if p >= 0)
    n_bytes = 4 * n_px + 4 * 32 + covered * 4 * N_GEO
    if src.mat_cols is not None:
        n_bytes += covered * 4 * n_mat
    else:
        n_bytes += covered * 4 + scene.materials.shape[0] * 4 * n_mat
    if stack_kernel:
        n_bytes += covered * 4 * sum(
            len(c) for k, c in enumerate(SLOT_CHANNELS) if slot_map[k] >= 0)
    elif n_sampled:
        rows = _gbuffer_rows(tri, src, scene, slot_map, stack_kernel)
        n_bytes += int(torch.unique(rows[rows >= 0]).numel()) * 16 * \
            n_sampled
    n_bytes += n_px * (4 * 17 + 1)
    return n_bytes, covered * GBUFFER_FLOPS_PER_PIXEL


def shading_work(args, kwargs):
    """(bytes, operations) of K9 on a recorded ``shading_pass_fast``
    call: the depth of every pixel read once and its colour written once,
    the other planes and SSAO of the lit pixels, the light rows, SH9 and
    level tables once, and of the specular and PCF tables the rows this
    frame's samples gather."""
    b = inspect.signature(Sh.shading_pass_fast).bind(*args, **kwargs)
    b.apply_defaults()
    (gbuf, _, rows, s, lights, n_lights, params, ibl, div, parent, mirror,
     merged, cb, row_offset, full_height) = b.arguments.values()
    h, w = gbuf.depth.shape
    n_px = h * w
    n_l = min(lights.shape[0], n_lights)
    half = Sh.half_res_geometry(gbuf, cb=cb)
    n_even = half[3].numel()
    n_sky = int((gbuf.depth >= 1.0).sum()) if ibl is not None else 0
    n_lit = n_px - n_sky
    n_bytes = (n_px * 4 * (1 + 3) + n_lit * 4 * (5 * 3 + 1)
               + n_l * lights.shape[1] * 4)
    flops = (n_lit * (SHADE_FLOPS_PER_PIXEL + SHADE_FLOPS_PER_LIGHT * n_l)
             + n_sky * SHADE_FLOPS_PER_SKY_PIXEL)
    gathered = {}
    if ibl is not None:
        eye = params["eye_pos"]
        n_bytes += 2 * 4 * ibl.specular_quad.num_levels + 9 * 3 * 4
        flops += n_lit * SHADE_IBL_FLOPS_PER_PIXEL
        if mirror:
            mirror_idx = Sh.even_grid_taps(
                half, eye, ibl, params, h, 2 * w if cb else w,
                merged and parent, row_offset, full_height)[3]
        else:
            mirror_idx = Sh.mirror_tap_full(gbuf, eye, ibl, params,
                                            row_offset, full_height)[1]
        table = "merged" if mirror and parent and merged else "spec"
        gathered[table] = [mirror_idx]
        if parent and not (mirror and merged):
            gathered.setdefault("spec", []).append(
                Sh.parent_tap(*half[:3], eye, ibl)[1])
        elif not parent:
            gathered.setdefault("spec", []).append(Sh.parent_tap(
                gbuf.position, gbuf.normal, gbuf.orm[..., 1], eye,
                ibl)[1][gbuf.depth < 1.0])
        flops += SHADE_FLOPS_PER_TAP * (
            (n_even if mirror else n_px) + (n_even if parent else n_px))
    if rows is not None:
        pos = gbuf.position if div == 1 else half[0]
        if div == 4:
            pos = pos[::2, ::2]
        x0, y0 = [a.to(torch.int64) for a in Sh.pcf_window_anchor(
            pos, params["light_proj_view"], s)[:2]]
        layout = Sh.pcf_layout(rows, s)
        if layout == Sh.PCF_U16_HALF:
            idx = [((y0 - 1) >> 1) * (s // 2) + ((x0 - 1) >> 1)]
        elif layout == Sh.PCF_U16_FULL:
            idx = [(y0 - 1) * s + x0 - 1]
        else:
            idx = [(y0 - 1) * s + x0 - 1, (y0 + 1) * s + x0 - 1]
        gathered["pcf"] = idx
        flops += pos[..., 0].numel() * SHADE_FLOPS_PER_PCF_SAMPLE
    row_bytes = {"spec": 16, "merged": 32, "pcf": 32}
    unique = {k: int(torch.unique(torch.cat([
        i.reshape(-1).to(torch.int64) for i in v])).numel())
        for k, v in gathered.items()}
    n_bytes += sum(row_bytes[k] * n for k, n in unique.items())
    return n_bytes, flops


def probe(render) -> dict:
    """Bound ms of one frame's passes on the fast path, from the calls
    ``render()`` (a reference frame) makes: {"gbuffer": K3 + K10,
    "shading": K9}; a pass the frame did not run is left out."""
    calls = {}

    def recorder(name, fn):
        def call(*args, **kwargs):
            calls.setdefault(name, []).append((args, kwargs))
            return fn(*args, **kwargs)
        return call

    with patched([(GB, "attr_planes", recorder("attr_planes",
                                               GB.attr_planes)),
                  (GB, "gbuffer_tail", recorder("gbuffer_tail",
                                                GB.gbuffer_tail)),
                  (FG, "shading_pass_fast",
                   recorder("shading", FG.shading_pass_fast))]), \
            torch.no_grad():
        render()
    with torch.no_grad():
        out = {}
        if "attr_planes" in calls and "gbuffer_tail" in calls:
            work = [attr_planes_work(*c) for c in calls["attr_planes"]] + [
                gbuffer_tail_work(*c) for c in calls["gbuffer_tail"]]
            out["gbuffer"] = bound_ms(sum(w[0] for w in work),
                                      sum(w[1] for w in work))
        if "shading" in calls:
            work = [shading_work(*c) for c in calls["shading"]]
            out["shading"] = bound_ms(sum(w[0] for w in work),
                                      sum(w[1] for w in work))
    return out
