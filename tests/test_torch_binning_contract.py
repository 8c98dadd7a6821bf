"""The contract of the port's ``bin_triangles`` that its CUDA kernels are
held to, checked here on the plain version (CPU) against pairs listed
one by one from the boxes; ``tests/test_torch_cuda.py`` runs the same
checks on the card's kernels.

- static and exact binning list the same runs while the pairs fit the
  capacity;
- past the capacity both drop the same count: static binning keeps the
  first triangles' pairs (the first slots in draw order), exact binning
  the lowest tiles;
- a band's runs are the whole frame's runs restricted to its tile rows,
  and its dropped count is its own pairs past the capacity.

This file imports no jax.
"""

import numpy as np
import pytest
import torch

from mo_renderer_tpu_torch.kernels import raster_setup as RS

W, H = 256, 128
TILE_H, TILE_W = 16, 32
NTX, NTY = W // TILE_W, H // TILE_H
N_TRI = 300  # more than one of the kernels' 256-triangle chunks


def soup_setup(device, n=N_TRI, seed=5):
    """Random triangles from a few pixels to a few screens wide, the first
    a full-screen one, through the port's setup on ``device``."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, [W, H], size=(n, 2))
    size = rng.choice([4.0, 30.0, 120.0], size=(n, 1), p=[0.6, 0.3, 0.1])
    pts = base[:, None] + rng.uniform(-1, 1, size=(n, 2, 2)) * size[:, None]
    pts = np.concatenate([base[:, None], pts], axis=1)  # (n, 3, 2)
    pts[0] = [[-10, -10], [3 * W, -10], [-10, 3 * H]]
    z = rng.uniform(0.1, 0.9, size=(n, 3, 1))
    clip = np.concatenate([pts[..., :1] / W * 2 - 1, pts[..., 1:] / H * 2 - 1,
                           z, np.ones((n, 3, 1))], -1).astype(np.float32)
    idx = torch.arange(3 * n, dtype=torch.int32).reshape(n, 3)
    return RS.triangle_setup(
        torch.from_numpy(clip.reshape(-1, 4)).to(device), idx.to(device),
        torch.ones(n, dtype=torch.bool, device=device), W, H,
        cull_backface=False)


def listed_pairs(setup, row0=None, rows=None):
    """Every (tile, triangle) pair of the setup's boxes, in slot order
    (draw order, each triangle's tiles row-major), one by one."""
    data = setup.tri_data.cpu().numpy()
    box = setup.bbox.cpu().numpy()
    out = []
    for t in range(box.shape[0]):
        if data[t, RS.COL_VALID] <= 0 or box[t, 0] > box[t, 2]:
            continue
        ty0, ty1 = box[t, 1] // TILE_H, box[t, 3] // TILE_H
        if row0 is not None:
            ty0, ty1 = max(ty0, row0), min(ty1, row0 + rows - 1)
        for ty in range(ty0, ty1 + 1):
            for tx in range(box[t, 0] // TILE_W, box[t, 2] // TILE_W + 1):
                out.append((ty * NTX + tx, t))
    return out


def runs(binned):
    """The (tile, triangle) pairs of every run, in run order; the run
    table packed from 0."""
    start = binned.tile_start.cpu().numpy()
    count = binned.tile_count.cpu().numpy()
    ids = binned.pair_tri.cpu().numpy()
    assert np.array_equal(start, np.concatenate([[0], np.cumsum(count)[:-1]]))
    return [(k, int(ids[i])) for k in range(NTX * NTY)
            for i in range(start[k], start[k] + count[k])]


def check_contract(case, static, device):
    setup = soup_setup(device)
    grid = dict(tile_h=TILE_H, tile_w=TILE_W, n_tiles_x=NTX, n_tiles_y=NTY)
    pairs = listed_pairs(setup)
    total = len(pairs)
    if case == "below_cap":
        for cap in (total, total + 9):
            b = RS.bin_triangles(setup, binned_cap=cap, static=static, **grid)
            assert runs(b) == sorted(pairs)
            assert int(b.overflow) == 0
            assert b.pair_tri.shape == ((cap,) if static else (total,))
    elif case == "past_cap":
        for cap in (total // 3, total - 1, 0):
            b = RS.bin_triangles(setup, binned_cap=cap, static=static, **grid)
            kept = sorted(pairs[:cap]) if static else sorted(pairs)[:cap]
            assert runs(b) == kept
            assert int(b.overflow) == total - cap
            assert b.pair_tri.shape == (cap,)
            assert torch.is_tensor(b.overflow) == static
    else:  # band
        whole = runs(RS.bin_triangles(setup, binned_cap=total,
                                      static=static, **grid))
        for row0, rows in ((0, 3), (3, 4), (7, 1), (2, 6)):
            band_pairs = listed_pairs(setup, row0, rows)
            cap = len(band_pairs) + 4
            b = RS.bin_triangles(setup, binned_cap=cap, static=static,
                                 band_row0=row0, band_tile_rows=rows, **grid)
            assert runs(b) == [p for p in whole
                               if row0 <= p[0] // NTX < row0 + rows]
            assert int(b.overflow) == 0
            short = RS.bin_triangles(setup, binned_cap=len(band_pairs) // 2,
                                     static=static, band_row0=row0,
                                     band_tile_rows=rows, **grid)
            assert int(short.overflow) == (len(band_pairs)
                                           - len(band_pairs) // 2)


CASES = [(case, static) for case in ("below_cap", "past_cap", "band")
         for static in (False, True)]


@pytest.mark.parametrize("case,static", CASES)
def test_binning_contract(case, static):
    check_contract(case, static, "cpu")
