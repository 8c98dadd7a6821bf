"""Checkerboard frame reconstruction (port of
``mo_renderer_tpu/passes/checkerboard.py``).

The shading passes produce the frame on the checkerboard domain, an
(H, W/2) plane of full pixels (y, 2j + (y&1)).  Each missing pixel is
filled from its four checkerboard neighbours (left/right on its row,
up/down on the adjacent rows), counting only neighbours on the same
triangle as the missing pixel (full-resolution ids); where none matches,
all four average.  The two planes are then interleaved to full width.

On a CUDA tensor ``reconstruct_full`` is one kernel, ``csrc/interleave.cu``
(the reference's interleave kernel K5 with the neighbour fill fused in);
on the CPU it is the plain version below, which the kernel matches
exactly (all arithmetic is on 8-bit channel values, exact in float32).
Frames are packed rgba8 held as int32 bit patterns.

``reconstruct_present`` is what the frame calls: the same kernel's second
entry, which takes the shaded float colour and quantises it on the way in
as ``present_pass`` does, so the checkerboard frame reaches the screen
format in one launch.  On the CPU it is ``present_pass`` followed by the
plain reconstruction, and the kernel equals that bit for bit.
"""

from __future__ import annotations

import torch

from ..kernels.decimate import decimate_cols, interleave_cols
from .present import present_pass

ALPHA_BITS = -16777216  # 0xFF000000 as an int32 bit pattern


def _up(a):  # row y reads a[y-1] (edge-clamped)
    return torch.cat([a[:1], a[:-1]], dim=0)


def _down(a):
    return torch.cat([a[1:], a[-1:]], dim=0)


def _prev_col(a):
    return torch.cat([a[:, :1], a[:, :-1]], dim=1)


def _next_col(a):
    return torch.cat([a[:, 1:], a[:, -1:]], dim=1)


def _unpack3(u):
    """(H, Wc) packed rgba8 (int32 bits) -> three float channel planes."""
    return [((u >> s) & 0xFF).to(torch.float32) for s in (0, 8, 16)]


def reconstruct_full(rgba_cb, tri_full):
    """(H, W/2) packed cb frame + (H, W) full-res triangle ids -> (H, W)
    packed frame (int32 bit patterns)."""
    return _reconstruct_plain(rgba_cb, tri_full)


def reconstruct_present(color_cb, tri_full):
    """(H, W/2, 3) float colour of the cb frame + (H, W) full-res triangle
    ids -> (H, W) packed frame: ``reconstruct_full(present_pass(color_cb),
    tri_full)``, one kernel on a CUDA tensor."""
    return _reconstruct_plain(present_pass(color_cb), tri_full)


def _reconstruct_plain(rgba_cb, tri_full):
    h, wc = rgba_cb.shape
    odd = (torch.arange(h, device=rgba_cb.device) & 1).to(torch.bool)[:, None]
    tri_cb = decimate_cols(tri_full, "cb")
    tri_anti = decimate_cols(tri_full, "anti")  # tri at missing pixels

    def neighbors(a):
        left = torch.where(odd, _prev_col(a), a)
        right = torch.where(odd, a, _next_col(a))
        return [left, right, _up(a), _down(a)]

    n_vals = [_unpack3(v) for v in neighbors(rgba_cb)]
    weights = [(t == tri_anti).to(torch.float32) for t in neighbors(tri_cb)]
    wsum = sum(weights)
    any_match = wsum > 0.0

    m = torch.full_like(rgba_cb, ALPHA_BITS)
    for c in range(3):
        vals = [v[c] for v in n_vals]
        num = sum(w * v for w, v in zip(weights, vals))
        avg = torch.where(
            any_match, num / torch.clamp(wsum, min=1.0), sum(vals) * 0.25
        )
        byte = torch.round(torch.clamp(avg, 0.0, 255.0)).to(torch.int32)
        m = m | (byte << (8 * c))

    even_plane = torch.where(odd, m, rgba_cb)
    odd_plane = torch.where(odd, rgba_cb, m)
    return interleave_cols(even_plane, odd_plane)


