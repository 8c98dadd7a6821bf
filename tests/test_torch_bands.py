"""The band modes of the port (the row-sharded frame's pieces) on their
plain versions, 4 bands of a 256x256 frame:

- band-local binning (``bin_triangles(band_row0=, band_tile_rows=)``):
  the band's runs are the whole frame's runs of its bin rows, pair for
  pair (tests/test_banded_binning.py:64), and a capped band counts only
  its own dropped pairs (:128);
- the band raster, K1b/K2b (``rasterize(tile_row_offset=)``): each band
  equals the same rows of the whole frame's raster bit for bit, from the
  whole frame's bins and from band-local bins (:92), and equals the JAX
  ``rasterize(tile_row_offset=)`` (Pallas in interpret mode) with ids
  exact and depth within atol 1e-6 (tests/test_rasterizer.py:138-139);
- SSAO with halo rows, K4b (``ssao_pass_tiles(y_halo=)``): each band
  equals the same rows of the whole-image pass exactly, and the JAX
  ``ssao_pass_pallas(row_offset, y_halo)`` within the SSAO bar of
  tests/test_ssao.py:56-57 (as tests/test_torch_ssao.py widens it, for
  the reference's f32 ``sin``); ``ssao_halo_rows`` is the reference's;
- the sky rays of a band (``_sky_dirs(row_offset, full_height)``) are the
  same rows of the whole frame's.

jax is imported inside the tests that need it.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mo_renderer_tpu_torch.kernels import raster_setup as RS  # noqa: E402
from mo_renderer_tpu_torch.kernels import rasterizer as R  # noqa: E402
from mo_renderer_tpu_torch.passes import ssao as S  # noqa: E402

W = H = 256
N_BANDS = 4
NTX, NTY = W // R.BIN_W, H // R.BIN_H  # 2 x 8 bins
BAND_BINS = NTY // N_BANDS
BAND_H = H // N_BANDS


def _soup(n=400, seed=3, huge=True):
    """Clip corners (n*3, 4) and indices: small, medium, large and (with
    ``huge``) one screen-covering triangle (test_banded_binning.py:17)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, [W, H], size=(n, 2)).astype(np.float32)
    size = np.concatenate([
        rng.uniform(2, 12, size=(n // 2, 1)),
        rng.uniform(20, 60, size=(n // 4, 1)),
        rng.uniform(80, 200, size=(n - n // 2 - n // 4, 1)),
    ]).astype(np.float32)
    rng.shuffle(size)
    d1 = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32) * size
    d2 = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32) * size
    pts = np.stack([base, base + d1, base + d2], axis=1)
    if huge:
        pts[0] = [[-10, -10], [3 * W, -10], [-10, 3 * H]]
    z = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    clip = np.concatenate([
        pts[..., 0:1] / W * 2.0 - 1.0, pts[..., 1:2] / H * 2.0 - 1.0,
        z[..., None], np.ones((n, 3, 1), np.float32),
    ], axis=-1).reshape(n * 3, 4).astype(np.float32)
    return clip, np.arange(n * 3, dtype=np.int32).reshape(n, 3)


def _port_setup(clip, idx):
    n = idx.shape[0]
    return RS.triangle_setup(torch.from_numpy(clip), torch.from_numpy(idx),
                             torch.ones(n, dtype=torch.bool), W, H,
                             cull_backface=False)


def _bin(setup, band=None, binned_cap=None):
    """The whole frame's or band ``band``'s bins, under ``binned_cap``
    (default: the reference's pair capacity)."""
    extra = {} if band is None else dict(band_row0=band * BAND_BINS,
                                         band_tile_rows=BAND_BINS)
    if binned_cap is None:
        binned_cap = RS.pair_capacity(setup.bbox.shape[0], NTX * NTY)
    return RS.bin_triangles(setup, tile_h=R.BIN_H, tile_w=R.BIN_W,
                            n_tiles_x=NTX, n_tiles_y=NTY,
                            binned_cap=binned_cap, **extra)


def _pairs_for_rows(binned, row0, rows):
    """[(tile, tri)] in run order for the given bin rows."""
    start, count = binned.tile_start.tolist(), binned.tile_count.tolist()
    ids = binned.pair_tri.tolist()
    return [(tile, ids[k])
            for tile in range(row0 * NTX, (row0 + rows) * NTX)
            for k in range(start[tile], start[tile] + count[tile])]


def test_band_pairs_match_the_whole_frame():
    setup = _port_setup(*_soup())
    whole = _bin(setup)
    assert whole.overflow == 0
    total = 0
    for d in range(N_BANDS):
        band = _bin(setup, d)
        want = _pairs_for_rows(whole, d * BAND_BINS, BAND_BINS)
        assert _pairs_for_rows(band, d * BAND_BINS, BAND_BINS) == want
        assert int(band.tile_count.sum()) == len(want)  # nothing outside
        count = band.tile_count.reshape(NTY, NTX)
        outside = torch.ones(NTY, dtype=torch.bool)
        outside[d * BAND_BINS: (d + 1) * BAND_BINS] = False
        assert int(count[outside].sum()) == 0
        torch.testing.assert_close(band.bbox, whole.bbox, rtol=0, atol=0)
        total += len(want)
    assert total == int(whole.tile_count.sum())


@pytest.mark.parametrize("mode", ["slim", "depth"])
def test_band_raster_is_the_whole_frame_rows(mode):
    setup = _port_setup(*_soup(seed=11))
    whole = _bin(setup)
    kw = dict(slim=True) if mode == "slim" else dict(depth_only=True)
    tri_f, z_f, _, _ = R.rasterize(whole, width=W, height=H, **kw)
    for d in range(N_BANDS):
        rows = slice(d * BAND_H, (d + 1) * BAND_H)
        for bins in (whole, _bin(setup, d)):
            tri_b, z_b, _, _ = R.rasterize(
                bins, width=W, height=BAND_H, tile_row_offset=d * BAND_BINS,
                **kw)
            assert torch.equal(z_b, z_f[rows]), f"band {d} depth"
            if mode == "slim":
                assert torch.equal(tri_b, tri_f[rows]), f"band {d} ids"
            else:
                assert tri_b is None


def test_band_overflow_counts_the_band_pairs_only():
    setup = _port_setup(*_soup(n=2000, seed=5, huge=False))
    cap = 64
    n_pairs = [int(_bin(setup, d).tile_count.sum()) for d in range(N_BANDS)]
    whole = _bin(setup)
    assert whole.overflow == 0
    assert sum(n_pairs) == int(whole.tile_count.sum())
    for d in range(N_BANDS):
        capped = _bin(setup, d, binned_cap=cap)
        assert capped.overflow == max(0, n_pairs[d] - cap) > 0
        assert capped.pair_tri.shape[0] == cap


def test_band_past_the_run_table_raises():
    setup = _port_setup(*_soup(n=20))
    with pytest.raises(ValueError, match="ends past"):
        R.rasterize(_bin(setup), width=W, height=BAND_H, slim=True,
                    tile_row_offset=NTY - 1)
    with pytest.raises(ValueError, match="slim or depth_only"):
        R.rasterize(_bin(setup), width=W, height=BAND_H, tile_row_offset=0)


def test_band_raster_matches_the_reference_band():
    """The reference's ``rasterize(tile_row_offset=)`` over its own bins
    of the same setup rows (16-row tiles, so its offset counts those)."""
    import jax.numpy as jnp

    from mo_renderer_tpu.kernels import raster_setup as JRS
    from mo_renderer_tpu.kernels.rasterizer import rasterize as j_rasterize

    clip, idx = _soup(seed=7)
    n = idx.shape[0]
    jsetup = JRS.triangle_setup(jnp.asarray(clip), jnp.asarray(idx),
                                jnp.ones(n, bool), W, H, cull_backface=False)
    jbins = JRS.bin_triangles(
        jsetup, tile_h=16, tile_w=128, n_tiles_x=W // 128, n_tiles_y=H // 16,
        max_tiles_per_tri=8, binned_cap=1 << 16, global_cap=64,
    )
    assert int(jbins.overflow) == 0
    setup = RS.TriangleSetup(torch.tensor(np.asarray(jsetup.tri_data)),
                             torch.tensor(np.asarray(jsetup.bbox)))
    for d in range(N_BANDS):
        bins = _bin(setup, d)
        for kw in (dict(slim=True), dict(depth_only=True)):
            ref_tri, ref_z, _, _ = j_rasterize(
                jbins, width=W, height=BAND_H, tile_h=16, tile_w=128,
                tile_row_offset=d * (BAND_H // 16), **kw)
            tri, z, _, _ = R.rasterize(bins, width=W, height=BAND_H,
                                       tile_row_offset=d * BAND_BINS, **kw)
            np.testing.assert_allclose(z.numpy(), np.asarray(ref_z),
                                       atol=1e-6, rtol=0)
            if "slim" in kw:
                np.testing.assert_array_equal(tri.numpy(),
                                              np.asarray(ref_tri))


@pytest.mark.parametrize("w", [128, 1024, 1920])
def test_ssao_halo_rows_match_the_reference(w):
    from mo_renderer_tpu.passes import ssao as JS

    assert S.ssao_halo_rows(w) == JS.ssao_halo_rows(w)


def _scene_depth(h, w, seed):
    """Planes at scene depths with discs in front and a sky band
    (tests/test_torch_ssao.py), so bands see real occlusion."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = 0.985 + 0.01 * yy / h
    for _ in range(10):
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(6, 24)
        inside = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        d = np.where(inside, d - rng.uniform(0.002, 0.02), d)
    d[: h // 8] = 1.0
    return np.clip(d, 0.0, 1.0).astype(np.float32)


def _halos(depth, n_bands):
    """Per band: (rows, band, top, bottom) as the row-sharded frame builds
    them, outer bands replicating their edge row."""
    h, w = depth.shape
    hr, bh = S.ssao_halo_rows(w), h // n_bands
    out = []
    for d in range(n_bands):
        band = depth[d * bh: (d + 1) * bh]
        top = (depth[d * bh - hr: d * bh] if d > 0
               else band[:1].expand(hr, w))
        bottom = (depth[(d + 1) * bh: (d + 1) * bh + hr] if d < n_bands - 1
                  else band[-1:].expand(hr, w))
        out.append((slice(d * bh, (d + 1) * bh), band, top.contiguous(),
                    bottom.contiguous()))
    return out


def test_ssao_bands_with_halos_are_the_whole_image_rows():
    depth = torch.from_numpy(_scene_depth(H, W, 3))
    whole = S.ssao_pass_tiles(depth)
    assert whole.min() < 0.99
    for rows, band, top, bottom in _halos(depth, N_BANDS):
        got = S.ssao_pass_tiles(band, row_offset=rows.start,
                                y_halo=(top, bottom))
        assert torch.equal(got, whole[rows]), f"rows {rows}"
    with pytest.raises(ValueError, match="halo planes"):
        S.ssao_pass_tiles(band, y_halo=(top[1:], bottom))


def test_ssao_bands_match_the_reference_bands():
    import jax
    import jax.numpy as jnp

    from mo_renderer_tpu.passes import ssao as JS

    h = 128  # 4 bands of 32 rows, taller than the 24 halo rows
    depth = torch.from_numpy(_scene_depth(h, W, 8))
    ref_band = jax.jit(lambda d, t, b, r: JS.ssao_pass_pallas(
        d, tile_h=16, tile_w=128, row_offset=r, y_halo=(t, b)))
    got, ref = [], []
    for rows, band, top, bottom in _halos(depth, N_BANDS):
        got.append(S.ssao_pass_tiles(band, row_offset=rows.start,
                                     y_halo=(top, bottom)).numpy())
        ref.append(np.asarray(ref_band(band.numpy(), top.numpy(),
                                       bottom.numpy(), rows.start)))
    got, ref = np.concatenate(got), np.concatenate(ref)
    assert ref.min() < 0.99
    diff = np.abs(got - ref)
    frac, far = (diff > 0).mean(), (diff > 1.01 / 255.0).mean()
    print(f"4 bands of {h // N_BANDS}x{W}: max |diff| {diff.max() * 255:.2f}"
          f"/255, {frac:.4%} of pixels differ, {far:.4%} by > 1.01/255")
    assert frac < 0.002 and far < 0.0002


@pytest.mark.parametrize("stride", [1, 2])
def test_band_sky_rays_are_the_whole_frame_rows(stride):
    from mo_renderer_tpu_torch.passes.shading import _sky_dirs

    rng = np.random.default_rng(0)
    basis = {
        "right": torch.tensor([1.0, 0.0, 0.0]),
        "up": torch.tensor([0.0, 1.0, 0.0]),
        "direction": torch.tensor(rng.normal(size=3).astype(np.float32)),
        "near": torch.tensor(0.1),
        "near_wh": torch.tensor([0.16, 0.09]),
    }
    whole = _sky_dirs(H, W, basis, stride=stride)
    for d in range(N_BANDS):
        band = _sky_dirs(BAND_H, W, basis, stride=stride,
                         row_offset=d * BAND_H, full_height=H)
        rows = slice(d * BAND_H // stride, (d + 1) * BAND_H // stride)
        assert torch.equal(band, whole[rows]), f"band {d}"
