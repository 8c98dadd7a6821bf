"""Column decimation / interleave for the checkerboard shading domain
(port of ``mo_renderer_tpu/kernels/decimate.py``).

cb pixel (y, j) <-> full pixel (y, 2j + (y&1)).  Decimation is plain
strided slicing.  The interleave that the reference ran as a TPU kernel
(K5, ``interleave_cols_pallas``) has a single caller,
``passes/checkerboard.reconstruct_full``; its CUDA kernel lives there,
fused with the neighbour fill and, in ``reconstruct_present``, with the
present pass.  ``interleave_cols`` here is the plain
form of the interleave alone.
"""

from __future__ import annotations

import torch


def _row_odd(h, device):
    return (torch.arange(h, device=device) & 1).to(torch.bool)[:, None]


def decimate_cols(x, phase=0):
    """(H, W) -> (H, ceil(W/2)): out[y, j] = x[y, 2j + p(y)] with
    phase 0 | 1 | "cb" (p = y&1) | "anti" (p = 1 - (y&1))."""
    if phase in (0, 1):
        return x[:, phase::2]
    if x.shape[1] % 2:
        raise ValueError(
            f"decimate_cols phase {phase!r} needs an even width, got "
            f"{x.shape[1]} (pad the plane by one edge column first)"
        )
    odd = _row_odd(x.shape[0], x.device)
    if phase == "anti":
        odd = ~odd
    return torch.where(odd, x[:, 1::2], x[:, 0::2])


def interleave_cols(a, b):
    """(H, W/2) x 2 -> (H, W): out[y, 2j] = a[y, j], out[y, 2j+1] = b[y, j]."""
    h, w2 = a.shape
    return torch.stack([a, b], dim=-1).reshape(h, 2 * w2)
