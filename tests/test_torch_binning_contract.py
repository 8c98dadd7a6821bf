"""The contract of the port's ``bin_triangles`` that its CUDA kernels are
held to, checked here on the plain version (CPU) against pairs listed
one by one from the boxes, on two random soups; ``tests/test_torch_cuda.py``
runs the same checks on the card's kernels.

- while the pairs fit the capacity the runs are every listed pair,
  sorted by (tile, draw order), in a pair table of the capacity's length;
- past the capacity the first triangles' pairs are kept (the first slots
  in draw order) and the rest counted as dropped, a 0-d device tensor;
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


def listed_pairs(setup, row0=None, rows=None, tile_h=TILE_H, tile_w=TILE_W,
                 n_tiles_x=NTX):
    """Every (tile, triangle) pair of the setup's boxes, in slot order
    (draw order, each triangle's tiles row-major), one by one; with
    ``row0`` and ``rows``, only those of that band of tile rows."""
    data = setup.tri_data.cpu().numpy()
    box = setup.bbox.cpu().numpy()
    out = []
    for t in range(box.shape[0]):
        if data[t, RS.COL_VALID] <= 0 or box[t, 0] > box[t, 2]:
            continue
        ty0, ty1 = box[t, 1] // tile_h, box[t, 3] // tile_h
        if row0 is not None:
            ty0, ty1 = max(ty0, row0), min(ty1, row0 + rows - 1)
        for ty in range(ty0, ty1 + 1):
            for tx in range(box[t, 0] // tile_w, box[t, 2] // tile_w + 1):
                out.append((ty * n_tiles_x + tx, t))
    return out


def runs(binned):
    """The (tile, triangle) pairs of every run, in run order; the run
    table packed from 0."""
    start = binned.tile_start.cpu().numpy()
    count = binned.tile_count.cpu().numpy()
    ids = binned.pair_tri.cpu().numpy()
    assert np.array_equal(start, np.concatenate([[0], np.cumsum(count)[:-1]]))
    return [(k, int(ids[i])) for k in range(len(count))
            for i in range(start[k], start[k] + count[k])]


def dropped(binned):
    """The dropped count, held to be a 0-d int64 tensor on the bins'
    device."""
    ovf = binned.overflow
    assert torch.is_tensor(ovf) and ovf.shape == () and (
        ovf.dtype == torch.int64 and ovf.device == binned.pair_tri.device)
    return int(ovf)


def check_contract(case, seed, device):
    setup = soup_setup(device, seed=seed)
    grid = dict(tile_h=TILE_H, tile_w=TILE_W, n_tiles_x=NTX, n_tiles_y=NTY)
    pairs = listed_pairs(setup)
    total = len(pairs)
    if case == "below_cap":
        for cap in (total, total + 9):
            b = RS.bin_triangles(setup, binned_cap=cap, **grid)
            assert runs(b) == sorted(pairs)
            assert dropped(b) == 0
            assert b.pair_tri.shape == (cap,)
    elif case == "past_cap":
        for cap in (total // 3, total - 1, 0):
            b = RS.bin_triangles(setup, binned_cap=cap, **grid)
            assert runs(b) == sorted(pairs[:cap])
            assert dropped(b) == total - cap
            assert b.pair_tri.shape == (cap,)
    else:  # band
        whole = runs(RS.bin_triangles(setup, binned_cap=total, **grid))
        for row0, rows in ((0, 3), (3, 4), (7, 1), (2, 6)):
            band_pairs = listed_pairs(setup, row0, rows)
            cap = len(band_pairs) + 4
            b = RS.bin_triangles(setup, binned_cap=cap, band_row0=row0,
                                 band_tile_rows=rows, **grid)
            assert runs(b) == [p for p in whole
                               if row0 <= p[0] // NTX < row0 + rows]
            assert dropped(b) == 0
            half = len(band_pairs) // 2
            short = RS.bin_triangles(setup, binned_cap=half, band_row0=row0,
                                     band_tile_rows=rows, **grid)
            assert runs(short) == sorted(band_pairs[:half])
            assert dropped(short) == len(band_pairs) - half


SEEDS = (5, 6)
CASES = [(case, seed) for case in ("below_cap", "past_cap", "band")
         for seed in SEEDS]


@pytest.mark.parametrize("case,seed", CASES)
def test_binning_contract(case, seed):
    check_contract(case, seed, "cpu")
