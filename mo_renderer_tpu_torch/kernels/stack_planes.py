"""Texture-stack planes: per consumed (slot, channel), the 8-bit channel
unpacked from the slot's four packed-RGBA8 quad texels and blended
bilinearly by the pixel's (fx, fy).

Port of ``mo_renderer_tpu/kernels/stack_planes.py`` (K7) with the
texture-stack row gathers of ``_texture_and_assemble`` fused in: the
wrapper takes the (H, W) stack-row index and the group tables
(``SceneBuffers.texture_stack_{a,b,c}``), not gathered rows.  CUDA
kernel: ``csrc/stack_planes.cu``.  The plain version is the math of the
reference's ``slot()`` (``passes/gbuffer.py:460``).

Output: one (n_planes, H, W) f32 tensor, one plane per ``out_spec``
entry.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from ..device import sampling

# channels of each material slot the G-buffer reads (base rgb, normal
# rgb, metallic-roughness g+b, occlusion r, emissive rgb)
SLOT_CHANNELS = ((0, 1, 2), (0, 1, 2), (1, 2), (0,), (0, 1, 2))

_INV255 = float(np.float32(1.0 / 255.0))  # what ``x * (1/255)`` multiplies by


def out_spec(slot_map, group_widths):
    """(spec, plane_of) for the sampled slots of ``slot_map``.

    ``group_widths``: the widths in words of the group tables (4 per
    slot quad).  Stack position p is the p-th quad over the groups in
    order, so the mapping follows the tables the scene packed, whatever
    their split.  ``spec`` holds one (group, first word, bit shift) per
    plane; ``plane_of[(slot, channel)]`` is the plane's index."""
    quads = [(g, 4 * q) for g, w in enumerate(group_widths)
             for q in range(w // 4)]
    spec, plane_of = [], {}
    for k, p in enumerate(slot_map):
        if p < 0:
            continue
        g, col = quads[p]
        for c in SLOT_CHANNELS[k]:
            plane_of[(k, c)] = len(spec)
            spec.append((g, col, 8 * c))
    return tuple(spec), plane_of


def stack_planes(idx, fx, fy, groups, spec):
    """idx (H, W) int32 stack rows; fx, fy (H, W) f32 bilinear fractions;
    groups: 1-3 (rows, 4k) int32 tables (uint32 bits); spec from
    :func:`out_spec`.  Returns (len(spec), H, W) f32."""
    if idx.is_cuda:
        return _stack_planes_cuda(idx, fx, fy, groups, spec)
    return _stack_planes_plain(idx, fx, fy, groups, spec)


def _stack_planes_plain(idx, fx, fy, groups, spec):
    rows = [sampling.take_rows(g, idx) for g in groups]
    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    planes = []
    for g, col, shift in spec:
        quad = rows[g][..., col : col + 4]
        v = ((quad >> shift) & 0xFF).to(torch.float32) * (1.0 / 255.0)
        planes.append(
            v[..., 0] * w00 + v[..., 1] * w10 + v[..., 2] * w01
            + v[..., 3] * w11
        )
    return torch.stack(planes, dim=0)


def _quad_table(spec):
    """Group the planes by quad (consecutive in ``spec``): rows of
    (group, col, n_chan, shift x4, first plane) for the C launcher."""
    rows = []
    for i, (g, col, shift) in enumerate(spec):
        if rows and rows[-1][:2] == [g, col] and rows[-1][2] < 4:
            rows[-1][3 + rows[-1][2]] = shift
            rows[-1][2] += 1
        else:
            rows.append([g, col, 1, shift, 0, 0, 0, i])
    return rows


def _stack_planes_cuda(idx, fx, fy, groups, spec):
    idx, fx, fy = idx.contiguous(), fx.contiguous(), fy.contiguous()
    groups = [g.contiguous() for g in groups]
    _build.require_cuda(
        "stack_planes", idx, fx, fy, *groups,
        dtypes=(torch.int32, torch.float32, torch.float32)
        + (torch.int32,) * len(groups),
    )
    if not 1 <= len(groups) <= 3:
        raise ValueError(f"stack_planes: {len(groups)} groups, expected 1-3")
    for g in groups:
        if g.dim() != 2 or g.shape[1] % 4 or g.data_ptr() % 16:
            raise ValueError(
                f"stack_planes: group {tuple(g.shape)} must be (rows, 4k), "
                "16-byte aligned"
            )
    for g, col, _ in spec:
        if g >= len(groups) or col + 4 > groups[g].shape[1]:
            raise ValueError(f"stack_planes: spec entry ({g}, {col}) is "
                             "outside the groups")
    quads = _quad_table(spec)
    h, w = idx.shape
    out = torch.empty((len(spec), h, w), dtype=torch.float32,
                      device=idx.device)
    if h * w == 0 or not spec:
        return out
    table = (ctypes.c_int * (8 * len(quads)))(*[v for r in quads for v in r])
    g3 = groups + [groups[0]] * (3 - len(groups))
    fn = _build.function(
        "mo_stack_planes",
        [_build.P] * 6 + [_build.I] * 3 + [_build.P, _build.I, _build.F,
                                            _build.P, _build.I, _build.P],
    )
    err = fn(
        idx.data_ptr(), fx.data_ptr(), fy.data_ptr(),
        *[g.data_ptr() for g in g3], *[g.shape[1] for g in g3],
        out.data_ptr(), h * w, _INV255, table, len(quads),
        _build.stream_of(out),
    )
    _build.check("stack_planes", err)
    _build.count("stack_planes")
    return out
