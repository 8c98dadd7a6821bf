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


import numpy as np
import torch

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


