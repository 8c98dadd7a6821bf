"""Present pass (port of ``mo_renderer_tpu/passes/present.py``): quantize
the tonemapped colour to rgba8, one packed word per pixel
(R | G<<8 | B<<16 | A<<24, held as int32 bits on the device).

The frames that are not checkerboarded call ``present_pass``.  A
checkerboard frame is quantised inside the reconstruct kernel instead
(``checkerboard.reconstruct_present``, ``csrc/interleave.cu``), with this
function's arithmetic: clamp to [0, 1], one rounding for the product with
255, round half to even, alpha 0xFF; there ``present_pass`` is the plain
version the kernel is held to."""

from __future__ import annotations

import numpy as np
import torch

ALPHA_BITS = -16777216  # 0xFF000000 as an int32 bit pattern


def present_pass(color):
    """color (H, W, 3) float [0, 1] -> (H, W) int32 packed rgba8 bits."""
    v = torch.round(torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.int32)
    return v[..., 0] | (v[..., 1] << 8) | (v[..., 2] << 16) | ALPHA_BITS


def unpack_rgba8(packed) -> np.ndarray:
    """Host side: (..., H, W) packed words -> (..., H, W, 4) uint8 — a
    byte view of the little-endian words."""
    if torch.is_tensor(packed):
        packed = packed.cpu().numpy()
    packed = np.ascontiguousarray(np.asarray(packed).view("<u4"))
    return packed.view(np.uint8).reshape(packed.shape + (4,))
