"""Reference (oracle) rasterizer in plain torch ops, O(T x pixels) (port of
``mo_renderer_tpu/kernels/raster_reference.py``).

Brute force: every triangle row is tested against every pixel centre,
with no binning.  It is the correctness oracle of the tile rasterizer
(``kernels/rasterizer.py``) in tests and on the card, and nothing on the
frame path calls it.  It takes the same 16-column rows
(``kernels/raster_setup.py``), tie bits (``COL_TIE``) included, and
keeps the reference oracle's arithmetic:

- a pixel centre is covered when each edge value (a*px + b*py) + c is
  > 0, or >= 0 on an edge whose tie bit is set, and the row is valid;
- depth z = zx*px + zy*py + zc, with the first product and the second
  fused (one multiply-add, as XLA contracts the reference's expression
  on the CPU; ``rasterizer._fused``);
- LessOrEqual depth test from far = 1.0 in row order, so the later row
  wins ties, and z must be >= 0;
- b0, b1 = the winner's edge values times ``inv_area`` (column 12).

The rows are taken in chunks, so the (T, H, W) product never exists at
once; within a chunk the winner of a pixel is the last row whose z
equals the pixel's new minimum depth, which is what the sequential
LessOrEqual walk keeps.
"""

from __future__ import annotations

import torch

from .raster_setup import (
    COL_INV_AREA,
    COL_TIE,
    COL_TRI_ID,
    COL_VALID,
    TriangleSetup,
)
from .rasterizer import _fused

FAR_DEPTH = 1.0
CHUNK_ELEMENTS = 1 << 22  # (rows x pixels) of one chunk


def _cover_and_depth(rows, px, py):
    """Coverage, depth and barycentrics of ``rows`` (C, 16) over the pixel
    centres ``px``/``py`` (H, W): four (C, H, W) planes."""

    def col(j):
        return rows[:, j, None, None]

    tie = rows[:, COL_TIE].to(torch.int32)[:, None, None]

    def edge(i):
        return (col(i) * px + col(3 + i) * py) + col(6 + i)

    def accept(w, bit):
        return torch.where((tie & bit) > 0, w >= 0, w > 0)

    w0, w1 = edge(0), edge(1)
    cover = (accept(w0, 1) & accept(w1, 2) & accept(edge(2), 4)
             & (col(COL_VALID) > 0))
    z = _fused(col(9), col(10), col(11), px, py)
    inv_area = col(COL_INV_AREA)
    return cover, z, w0 * inv_area, w1 * inv_area


def rasterize_reference(setup: TriangleSetup, width: int, height: int):
    """Visibility buffer of ``setup.tri_data``: (tri_id int32 (H, W), -1 =
    background; depth f32 (H, W); b0 f32 (H, W); b1 f32 (H, W)), 0 where
    nothing covers."""
    tri_data = setup.tri_data
    dev = tri_data.device
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")

    tri = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    depth = torch.full((height, width), FAR_DEPTH, dtype=torch.float32,
                       device=dev)
    b0 = torch.zeros((height, width), dtype=torch.float32, device=dev)
    b1 = torch.zeros_like(b0)
    chunk = max(1, CHUNK_ELEMENTS // (width * height))
    for lo in range(0, tri_data.shape[0], chunk):
        rows = tri_data[lo: lo + chunk]
        cover, z, bb0, bb1 = _cover_and_depth(rows, px, py)
        zin = torch.where(cover & (z >= 0.0), z, torch.inf)
        new_depth = torch.minimum(depth, zin.amin(dim=0))
        # the last row of the chunk that reaches the new depth wins; none
        # does where an earlier chunk keeps the pixel
        order = torch.arange(rows.shape[0], device=dev)[:, None, None]
        last = torch.where(zin == new_depth, order, -1).amax(dim=0)
        win = last >= 0
        k = last.clamp(min=0)[None].to(torch.int64)
        tri = torch.where(
            win, rows[:, COL_TRI_ID].to(torch.int32)[last.clamp(min=0)], tri)
        b0 = torch.where(win, bb0.gather(0, k)[0], b0)
        b1 = torch.where(win, bb1.gather(0, k)[0], b1)
        depth = new_depth
    return tri, depth, b0, b1
