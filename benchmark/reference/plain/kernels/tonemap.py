"""Tonemap and colour-space ops (port of
``mo_renderer_tpu/kernels/tonemap.py``; resources/shaders/include/
{tonemap,utility}.glsl)."""

from __future__ import annotations

import torch


def tonemap_unreal(x):
    """Unreal 3 fit with gamma 2.2 baked in (tonemap.glsl:35-37), the
    tonemap the shading pass uses (shading_pass.frag:116)."""
    return x / (x + 0.155) * 1.019


def srgb_to_linear(srgb):
    """utility.glsl toLinear (:15-22), piecewise."""
    return torch.where(
        srgb < 0.04045,
        srgb / 12.92,
        torch.pow(torch.clamp((srgb + 0.055) / 1.055, min=0.0), 2.4),
    )
