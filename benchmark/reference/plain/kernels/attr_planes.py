"""Per-pixel attribute planes from the visibility buffer.

Port of ``mo_renderer_tpu/kernels/attr_planes.py`` (K3) with the
``tri_attrs`` row gather of ``gbuffer_pass_fast`` fused in: for every
pixel of a visibility plane it reads the triangle id, takes the row of
``t = max(tri, 0)`` (as the reference does for uncovered pixels), builds
perspective-correct homogeneous barycentrics against the pixel's NDC and
interpolates.  CUDA kernel: ``csrc/attr_planes.cu``.

Output: one (16 + n_mat, H, W) f32 tensor whose planes are, in order,
wp.xyz, n.xyz, t.xyz, bt.xyz, uv0.uv, mat_id, handed, mat_cols... —
the reference's plane order.  Column offsets come from the ``TRI_*``
constants of ``passes/vertex_stage.py``.
"""

from __future__ import annotations

import torch

from ..passes.vertex_stage import (
    TRI_HANDED,
    TRI_MAT,
    TRI_N0,
    TRI_STRIDE,
    TRI_T0,
    TRI_UV0,
    TRI_WP0,
)


def n_planes(n_mat: int) -> int:
    return 16 + n_mat


def pixel_ndc(shape, full_wh, *, cb=False, y0=0, device=None):
    """NDC (nx, ny) of every pixel centre of an (H, W) visibility plane,
    or of the (H, W/2) checkerboard domain (columns 2j + (y & 1)) when
    ``cb``; ``full_wh`` is the raster target size (gbuffer.py:200)."""
    h, wd = shape
    full_w, full_h = full_wh
    yy = y0 + torch.arange(h, dtype=torch.int32, device=device)[:, None]
    xx = torch.arange(wd, dtype=torch.int32, device=device)[None, :]
    xx = 2 * xx + (yy & 1) if cb else xx.expand(h, wd)
    nx = (xx.to(torch.float32) + 0.5) * (2.0 / full_w) - 1.0
    ny = (yy.to(torch.float32) + 0.5) * (2.0 / full_h) - 1.0
    return nx, ny.expand(h, wd)


def attr_planes(tri, tri_attrs, proj_view, *, n_mat: int, full_wh,
                cb: bool = False, y0: int = 0):
    """tri (H, W) int32 visibility ids (-1 = background); tri_attrs
    (T, 35 + n_mat) f32; proj_view (4, 4) f32.  Returns (16 + n_mat, H, W)
    f32 planes (see module docstring)."""
    if tri_attrs.shape[1] != TRI_STRIDE + n_mat:
        raise ValueError(
            f"tri_attrs has {tri_attrs.shape[1]} columns, expected "
            f"{TRI_STRIDE} + {n_mat}"
        )
    return _attr_planes_plain(tri, tri_attrs, proj_view, n_mat, full_wh,
                              cb, y0)


def _attr_planes_plain(tri, tri_attrs, proj_view, n_mat, full_wh, cb, y0):
    nx, ny = pixel_ndc(tri.shape, full_wh, cb=cb, y0=y0, device=tri.device)
    row = tri_attrs[torch.clamp(tri, min=0).to(torch.int64)]  # (H, W, C)
    pv = proj_view

    def ch(c):
        return row[..., c]

    u, v = [], []
    for k in range(3):
        b = TRI_WP0 + 3 * k
        wx, wy, wz = ch(b), ch(b + 1), ch(b + 2)
        xk = wx * pv[0, 0] + wy * pv[0, 1] + wz * pv[0, 2] + pv[0, 3]
        yk = wx * pv[1, 0] + wy * pv[1, 1] + wz * pv[1, 2] + pv[1, 3]
        wk = wx * pv[3, 0] + wy * pv[3, 1] + wz * pv[3, 2] + pv[3, 3]
        u.append(xk - nx * wk)
        v.append(yk - ny * wk)
    q0 = u[1] * v[2] - u[2] * v[1]
    q1 = u[2] * v[0] - u[0] * v[2]
    q2 = u[0] * v[1] - u[1] * v[0]
    qs = q0 + q1 + q2
    qs = torch.where(qs.abs() > 1e-30, qs, 1.0)
    bb0, bb1, bb2 = q0 / qs, q1 / qs, q2 / qs

    def interp(base, width, c):
        return (
            ch(base + c) * bb0
            + ch(base + width + c) * bb1
            + ch(base + 2 * width + c) * bb2
        )

    wp = [interp(TRI_WP0, 3, c) for c in range(3)]
    n = [interp(TRI_N0, 3, c) for c in range(3)]
    tg = [interp(TRI_T0, 3, c) for c in range(3)]
    handed = ch(TRI_HANDED)
    bt = [
        (n[1] * tg[2] - n[2] * tg[1]) * handed,
        (n[2] * tg[0] - n[0] * tg[2]) * handed,
        (n[0] * tg[1] - n[1] * tg[0]) * handed,
    ]
    planes = wp + n + tg + bt + [
        interp(TRI_UV0, 2, 0), interp(TRI_UV0, 2, 1), ch(TRI_MAT), handed,
    ] + [ch(TRI_STRIDE + m) for m in range(n_mat)]
    return torch.stack(planes, dim=0)


