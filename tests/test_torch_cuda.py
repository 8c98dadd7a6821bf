"""Card-only checks of the PyTorch port's CUDA kernels.

Marked ``cuda``; they skip where no CUDA device is present (the CPU
suite).  This file imports no ``jax``, so it also runs where jax is not
installed; ``tests/conftest.py`` imports jax, so run it there without
the conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

``python3 chip_smoke.py`` runs the same checks at 1920x1080.  The
interactive and sequence checks replay each path's CUDA graph against its
eager frames, and the binning kernels are held to pairs listed one by one
on random soups.  The
random soups below hold the full-mode raster (K6) and the megakernel (K8)
to their plain versions away from the frame's own inputs; the cases after
them aim at the seams of the region walk that raster.cu and
raster_attrs.cu share (a run that ends on, before or after a staged chunk,
boxes that end on a warp's rows or on a region or bin border, equal
depths, ragged targets), each for both sources; of the band raster's
(K1b/K2b: odd band counts, bands of one bin row, a band cut short,
near-plane triangles across a band border, from whole and band-local
bins, each band also against the whole-frame kernel); of the SSAO
kernel's (ragged planes, a row offset, three widths) and of its halo
form's (K4b: bands shorter than their halo, ragged bands, against the
whole-image kernel); of the reconstruct
kernel's two entries (planes of odd or unaligned width, strips that end
inside a warp, one row); of the shading kernel's (K9: random G-buffers,
its even-grid samples through the debug planes, every discrete choice it
makes at full rate with and without sky, the tiny scene's sky-free frame,
one launch, no fallback); of the G-buffer tail's (K10: random inputs laid
out as each of its five sources has them, through its debug rows, no
fallback on any fast path's frame); and of the reference path's shading
kernel's (K11: random G-buffers under every option set, 1 to 16 lights,
its discrete choices through its debug output, no fallback); of K9 and
K11 on light tables of 5, 538, 539 and 1025 rows (one chunk of their
shared memory, one row past it, two chunks; each table also behind dark
rows that move it against the chunk borders, bit for bit); and of the
reference path's G-buffer kernel's (K12: random scenes aimed at its
discontinuities, its texel anchors and UV sets through its debug output,
the UV1, all-slots and no-tangent calls, no fallback).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402
import torch  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card(cuda):
    """Every kernel against its plain version on the 256x128 frames' own
    inputs (chip_smoke's phase 2 at the small size), the shading kernels
    also with 1025 light rows."""
    import chip_smoke
    from mo_renderer_tpu_torch import scenes

    results = chip_smoke.check_kernels(scenes.tiny_config(), cuda)
    lit = {f"{name}@lit" for name in chip_smoke.LIT_KERNELS}
    assert set(results) == set(chip_smoke.KERNELS) | {
        f"{name}@grid" for name in chip_smoke.GRID_KERNELS
        + chip_smoke.BAND_GRID_KERNELS} | lit | {
        f"{name}@lit/1025" for name in chip_smoke.MANY_LIGHT_KERNELS}
    assert all(results[name]["sky_pixels"] == 0 for name in lit)


@pytest.mark.cuda
def test_card_frame_matches_cpu_frame(cuda):
    """The 256x128 frames of the three paths and the UV1 scene."""
    import chip_smoke

    chip_smoke.check_small_frames(cuda)


@pytest.mark.cuda
def test_oracle_matches_full_mode_on_the_card(cuda):
    """The oracle rasterizer equals K6 on the tiny scene's rows
    (chip_smoke's phase 5)."""
    import chip_smoke

    chip_smoke.check_oracle(cuda)


@pytest.mark.cuda
def test_bench_runs_on_the_card(cuda):
    """The bench at 256x128, per frame and replayed: bench.py's keys, the
    card named, a frame that is not black."""
    from mo_renderer_tpu_torch import bench, scenes

    for seq in (1, 4):
        res = bench.run(scenes.tiny_config(), cuda, frames=4, seq=seq)
        assert res["backend"] == "cuda" and res["card"]
        assert res["frames_per_dispatch"] == seq and res["value"] > 0


@pytest.mark.cuda
def test_interactive_loop_on_the_card(cuda):
    """Spawns, a despawn and a fallback on the card against a fresh
    prepare and the CPU; the window loop with a live resize and
    present_divisor=2 (chip_smoke's phase 3)."""
    import chip_smoke

    chip_smoke.check_topology(cuda)
    chip_smoke.check_window_loop(cuda)


@pytest.mark.cuda
def test_sequences_and_passes_on_the_card(cuda):
    """A probe RenderPass on the card against the CPU; every path's
    sequence, replayed from its CUDA graph, against the eager frames bit
    for bit; the binning kernels and the graph's overflow sum on the card
    (chip_smoke's phase 3)."""
    import chip_smoke

    chip_smoke.check_render_pass(cuda)
    chip_smoke.check_sequences(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["default", "reference", "megakernel",
                                  "stacks", "rows", "default+pass"])
def test_interactive_replay_equals_eager(cuda, path):
    """``render_device`` replayed from its layout-keyed CUDA graph equals
    the eager frame bit for bit through moves, a spawn, a despawn, a light
    move and a resize, captures once per key, and counts the eager
    frames' dropped pairs past the capacity (chip_smoke's ``[3]
    interactive``); the rows path on an NCCL world of one."""
    import chip_smoke

    if path != "rows":
        chip_smoke.check_interactive(cuda, None, paths=(path,))
        return
    with chip_smoke.nccl_world_of_one() as group:
        chip_smoke.check_interactive(cuda, group, paths=(path,))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_static_binning_matches_exact_binning(cuda, seed):
    """Random soups on the card: the binning kernels list the pairs
    listed one by one from the boxes (the exact pairs), sorted by tile
    and draw order, while they fit the capacity, and past it keep the
    first triangles' pairs and count the rest on the device; runs, boxes
    and counts equal the plain version's."""
    from test_torch_binning_contract import listed_pairs, runs

    from mo_renderer_tpu_torch.kernels import raster_setup as RS
    from mo_renderer_tpu_torch.kernels import rasterizer as R

    setup = _soup_setup(seed, 400, 640, 200, device=cuda)
    kw = dict(tile_h=R.BIN_H, tile_w=R.BIN_W, n_tiles_x=5, n_tiles_y=7)
    pairs = listed_pairs(setup, tile_h=R.BIN_H, tile_w=R.BIN_W, n_tiles_x=5)
    total = len(pairs)
    cpu = RS.TriangleSetup(setup.tri_data.cpu(), setup.bbox.cpu())
    for cap in (total + 8, total, total // 3):
        got = RS.bin_triangles(setup, binned_cap=cap, **kw)
        plain = RS.bin_triangles(cpu, binned_cap=cap, **kw)
        assert got.pair_tri.shape == (cap,) and got.overflow.is_cuda
        assert int(got.overflow) == int(plain.overflow) == max(total - cap,
                                                               0)
        assert runs(got) == runs(plain) == sorted(pairs[:cap])
        assert torch.equal(got.bbox.cpu(), plain.bbox)


def _soup_setup(seed, n_tri, width, height, extra_cols=0, device="cpu"):
    """Random triangles through the port's own setup, with
    ``extra_cols`` random megakernel columns (1/w corners in (0.2, 2))."""
    import numpy as np

    from mo_renderer_tpu_torch.kernels import raster_setup as RS

    rng = np.random.default_rng(seed)
    pts = rng.uniform([0, 0], [width, height], size=(n_tri * 3, 2))
    clip = np.stack([pts[:, 0] / width * 2 - 1, pts[:, 1] / height * 2 - 1,
                     rng.uniform(0.05, 0.95, n_tri * 3),
                     np.ones(n_tri * 3)], -1).astype(np.float32)
    idx = torch.arange(n_tri * 3, dtype=torch.int32).reshape(n_tri, 3)
    setup = RS.triangle_setup(torch.from_numpy(clip), idx,
                              torch.ones(n_tri, dtype=torch.bool), width,
                              height, cull_backface=False)
    if extra_cols:
        extra = rng.normal(size=(n_tri, extra_cols)).astype(np.float32)
        extra[:, :3] = rng.uniform(0.2, 2.0, size=(n_tri, 3))
        extra[:, -2] = rng.integers(0, 7, n_tri)
        extra[:, -1] = rng.integers(0, 2, n_tri)
        setup.tri_data = torch.cat([setup.tri_data, torch.from_numpy(extra)],
                                   dim=1)
    setup.tri_data = setup.tri_data.to(device)
    setup.bbox = setup.bbox.to(device)
    return setup


def _bins_of(setup, width, height, **band):
    """``setup`` binned over a ``width`` x ``height`` target under the
    reference's pair capacity (``band``: ``bin_triangles``' band
    keywords)."""
    from mo_renderer_tpu_torch.kernels import raster_setup as RS
    from mo_renderer_tpu_torch.kernels import rasterizer as R

    nx, ny = -(-width // R.BIN_W), -(-height // R.BIN_H)
    return RS.bin_triangles(
        setup, tile_h=R.BIN_H, tile_w=R.BIN_W, n_tiles_x=nx, n_tiles_y=ny,
        binned_cap=RS.pair_capacity(setup.bbox.shape[0], nx * ny), **band)


def _soup_binned(seed, n_tri, width, height, extra_cols=0, device="cpu"):
    """``_soup_setup``'s triangles binned (``_bins_of``)."""
    return _bins_of(
        _soup_setup(seed, n_tri, width, height, extra_cols, device), width,
        height)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_full_raster_kernel_matches_plain(cuda, seed):
    """K6 on a random soup: ids and depth exact, b0/b1 within 1e-6."""
    from mo_renderer_tpu_torch.kernels import rasterizer as R

    binned = _soup_binned(seed, 400, 640, 200, device=cuda)
    k = R._raster_cuda(binned, 640, 200, "full")
    p = R._raster_plain(binned, 640, 200, "full")
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    for a, b in zip(k[2:], p[2:]):
        assert (a - b).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_raster_attrs_kernel_matches_plain(cuda, seed):
    """K8 on a random soup: ids, depth, material and handedness exact,
    the 14 planes within rtol 2e-3 / atol 1e-4."""
    from mo_renderer_tpu_torch.kernels import rasterizer as R
    from mo_renderer_tpu_torch.passes.vertex_stage import RA_EXTRA_COLS

    binned, attr_rows = R.split_attr_rows(
        _soup_binned(seed, 400, 640, 200, RA_EXTRA_COLS, device=cuda))
    assert binned.tri_data.shape[1] == 16 and attr_rows.shape[1] == 48
    tri_k, z_k, planes_k = R._raster_attrs_cuda(binned, attr_rows, 640, 200)
    tri_p, z_p, planes_p = R._raster_attrs_plain(binned, attr_rows, 640, 200)
    assert torch.equal(tri_k, tri_p) and torch.equal(z_k, z_p)
    assert torch.equal(planes_k[R.N_INTERP:], planes_p[R.N_INTERP:])
    assert torch.allclose(planes_k, planes_p, rtol=2e-3, atol=1e-4)


def _binned_from_points(pts, z, width, height, device):
    """Triangles from pixel-space corners ``pts`` (3n, 2) and depths ``z``
    (3n,), through the port's own setup and binning."""
    import numpy as np

    from mo_renderer_tpu_torch.kernels import raster_setup as RS
    from mo_renderer_tpu_torch.kernels import rasterizer as R

    n_tri = len(pts) // 3
    clip = np.stack([pts[:, 0] / width * 2 - 1, pts[:, 1] / height * 2 - 1,
                     z, np.ones(len(pts))], -1).astype(np.float32)
    idx = torch.arange(n_tri * 3, dtype=torch.int32).reshape(n_tri, 3)
    setup = RS.triangle_setup(torch.from_numpy(clip), idx,
                              torch.ones(n_tri, dtype=torch.bool), width,
                              height, cull_backface=False)
    setup.tri_data = setup.tri_data.to(device)
    setup.bbox = setup.bbox.to(device)
    return _bins_of(setup, width, height)


KERNELS = ["raster", "raster_attrs"]  # the sources that share the walk


def _assert_raster_modes_exact(binned, width, height, kernel="raster"):
    """``raster``: all three modes of raster.cu against the plain version,
    ids and depth equal, b0/b1 within 1e-6.  ``raster_attrs``: the
    megakernel on the same triangles with random attribute rows, ids,
    depth, material and handedness equal, the 14 planes within rtol 2e-3 /
    atol 1e-4.  Returns the visibility ids."""
    import numpy as np

    from mo_renderer_tpu_torch.kernels import rasterizer as R

    if kernel == "raster_attrs":
        n_tri = binned.tri_data.shape[0]
        rng = np.random.default_rng(n_tri)
        rows = rng.normal(size=(n_tri, R.ATTR_ROW)).astype(np.float32)
        rows[:, :3] = rng.uniform(0.2, 2.0, size=(n_tri, 3))
        rows[:, R.ATTR_COLS - 2] = rng.integers(0, 7, n_tri)
        rows[:, R.ATTR_COLS - 1] = rng.integers(0, 2, n_tri)
        rows[:, R.ATTR_COLS:] = 0.0
        attr_rows = torch.from_numpy(rows).to(binned.tri_data.device)
        tri, z, planes = R._raster_attrs_cuda(binned, attr_rows, width,
                                              height)
        tri_p, z_p, planes_p = R._raster_attrs_plain(binned, attr_rows,
                                                     width, height)
        torch.cuda.synchronize()
        assert torch.equal(tri, tri_p) and torch.equal(z, z_p)
        assert torch.equal(planes[R.N_INTERP:], planes_p[R.N_INTERP:])
        assert torch.allclose(planes, planes_p, rtol=2e-3, atol=1e-4)
        # zero planes where no triangle covers, also where z stayed 1
        assert bool((planes[:, z >= 1.0] == 0).all())
        return tri
    for mode in ("slim", "depth", "full"):
        k = R._raster_cuda(binned, width, height, mode)
        p = R._raster_plain(binned, width, height, mode)
        torch.cuda.synchronize()
        assert torch.equal(k[1], p[1]), mode
        if mode != "depth":
            assert torch.equal(k[0], p[0]), mode
        if mode == "full":
            for a, b in zip(k[2:], p[2:]):
                assert (a - b).abs().max().item() <= 1e-6
        if mode == "slim":
            tri = k[0]
    return tri


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("n_tri", [0, 1, 63, 64, 65, 129, 255, 256, 257,
                                   511, 512, 513, 1000])
def test_raster_run_lengths_in_one_tile(cuda, n_tri, kernel):
    """A run of n triangles in ONE bin tile (the kernel stages 256 pairs
    at a time), overlapping at random depths, the other tiles empty.  The
    run of 0 is one triangle without area, which setup drops."""
    import numpy as np

    width, height = 384, 96
    rng = np.random.default_rng(n_tri)
    # corners stay inside the tile at x 128..255, y 32..63
    c = rng.uniform([143, 46], [241, 50], size=(max(n_tri, 1), 1, 2))
    spread = np.array([14.0, 13.0]) if n_tri else 0.0
    pts = c + rng.uniform(-1, 1, size=(max(n_tri, 1), 3, 2)) * spread
    pts = pts.reshape(-1, 2)
    binned = _binned_from_points(pts, rng.uniform(0.05, 0.95, len(pts)),
                                 width, height, cuda)
    counts = binned.tile_count.cpu()
    # one tile holds them all
    assert int(counts.sum()) == int(counts.max()) == n_tri
    tri = _assert_raster_modes_exact(binned, width, height, kernel)
    assert (n_tri == 0) == bool((tri < 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_raster_boxes_on_the_seams(cuda, seed, kernel):
    """Corners on multiples of half a pixel around the borders of a bin
    tile (x = 128, y = 32), a region (x = 32k) and a warp's rows (y = 4k):
    edges through pixel centres, boxes that end exactly on a seam."""
    import numpy as np

    width, height = 384, 96
    rng = np.random.default_rng(seed)
    n_tri = 400
    seam = np.stack([rng.choice([32, 64, 96, 128, 160, 256], n_tri),
                     rng.choice([4, 8, 28, 32, 36, 60, 64], n_tri)], -1)
    pts = seam[:, None, :] + rng.integers(-16, 17, size=(n_tri, 3, 2)) / 2.0
    pts = np.clip(pts.reshape(-1, 2), 0, [width, height])
    binned = _binned_from_points(pts, rng.uniform(0.05, 0.95, n_tri * 3),
                                 width, height, cuda)
    tri = _assert_raster_modes_exact(binned, width, height, kernel)
    assert (tri >= 0).float().mean().item() > 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("seed,n_near", [(0, 1), (1, 2)])
def test_raster_near_plane_triangles(cuda, seed, n_near, kernel):
    """Triangles with corners right in front of the eye plane (w from
    1.1e-6 up, screen coordinates of 1e8 pixels and more), whose float
    edge functions can cover pixels outside the setup's box: binning gives
    them the box of their tiles, and the kernel equals the plain version."""
    import numpy as np

    from mo_renderer_tpu_torch.kernels import raster_setup as RS
    from mo_renderer_tpu_torch.kernels import rasterizer as R

    width, height, n_tri = 384, 96, 400
    rng = np.random.default_rng(seed)
    ndc = rng.uniform(-1.2, 1.2, size=(n_tri, 3, 2))
    w = np.ones((n_tri, 3))
    w[:, :n_near] = np.exp(rng.uniform(np.log(1.1e-6), np.log(0.1),
                                       size=(n_tri, n_near)))
    xy = ndc.copy()
    xy[:, n_near:] *= w[:, n_near:, None]
    z = rng.uniform(0.05, 0.95, size=(n_tri, 3)) * w
    clip = np.concatenate([xy, z[..., None], w[..., None]], -1)
    clip = torch.from_numpy(clip.reshape(-1, 4).astype(np.float32))
    idx = torch.arange(n_tri * 3, dtype=torch.int32).reshape(n_tri, 3)
    setup = RS.triangle_setup(clip, idx, torch.ones(n_tri, dtype=torch.bool),
                              width, height, cull_backface=False)
    setup.tri_data = setup.tri_data.to(cuda)
    setup.bbox = setup.bbox.to(cuda)
    binned = _bins_of(setup, width, height)
    assert int((binned.bbox != setup.bbox).any(1).sum()) > 20
    tri = _assert_raster_modes_exact(binned, width, height, kernel)
    assert (tri >= 0).float().mean().item() > 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
def test_raster_coplanar_duplicates_keep_the_later(cuda, kernel):
    """The same 300 triangles drawn twice: equal depths everywhere, so the
    second copy's ids win every covered pixel."""
    import numpy as np

    width, height = 384, 96
    rng = np.random.default_rng(5)
    n_tri = 300
    pts = rng.uniform([0, 0], [width, height], size=(n_tri * 3, 2))
    z = rng.uniform(0.05, 0.95, n_tri * 3)
    binned = _binned_from_points(np.concatenate([pts, pts]),
                                 np.concatenate([z, z]), width, height, cuda)
    tri = _assert_raster_modes_exact(binned, width, height, kernel)
    covered = tri[tri >= 0]
    assert covered.numel() > 1000 and bool((covered >= n_tri).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("width,height", [(200, 77), (333, 45), (129, 33),
                                          (31, 3)])
def test_raster_ragged_targets(cuda, width, height, kernel):
    """Width and height that are no multiple of the bin, the region or a
    warp's rows."""
    import numpy as np

    rng = np.random.default_rng(width)
    n_tri = 250
    pts = rng.uniform([-8, -8], [width + 8, height + 8], size=(n_tri * 3, 2))
    binned = _binned_from_points(pts, rng.uniform(0.05, 0.95, n_tri * 3),
                                 width, height, cuda)
    tri = _assert_raster_modes_exact(binned, width, height, kernel)
    assert tri.shape == (height, width) and bool((tri >= 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,row_offset", [
    (37, 128, 48), (50, 1024, 7), (45, 1920, 1043), (64, 1000, 0),
])
def test_ssao_kernel_ragged_planes_and_row_offset(cuda, h, w, row_offset):
    """K4 at sizes that are no multiple of its tile, with a row offset:
    exact against the plain version."""
    import numpy as np

    from mo_renderer_tpu_torch.passes import ssao as S

    rng = np.random.default_rng(h * w)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = 0.985 + 0.01 * yy / h
    for _ in range(8):
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(6, 24)
        d = np.where((xx - cx) ** 2 + (yy - cy) ** 2 < r * r,
                     d - rng.uniform(0.002, 0.02), d)
    d[: h // 8] = 1.0
    depth = torch.from_numpy(np.clip(d, 0.0, 1.0).astype(np.float32)).to(cuda)
    args = (depth, S.NUM_LEVELS, row_offset, S.NEAR, S.FAR)
    plain = S._ssao_plain(*args)
    assert plain.min().item() < 0.99
    out = S._ssao_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)


def _assert_bands_exact(setup, width, height, bands):
    """K1b and K2b on ``bands`` -- (first bin row, bin rows) -- of the
    target: each band from the whole frame's bins and from its own
    band-local bins equals its plain version and the same rows of the
    whole-frame kernel (ids and depth exact)."""
    from mo_renderer_tpu_torch.kernels import rasterizer as R

    whole = _bins_of(setup, width, height)
    covered = 0
    for mode, kw in (("slim", dict(slim=True)),
                     ("depth", dict(depth_only=True))):
        tri_w, z_w, _, _ = R._raster_cuda(whole, width, height, mode)
        for row0, n_rows in bands:
            y0 = row0 * R.BIN_H
            h = min(n_rows * R.BIN_H, height - y0)
            local = _bins_of(setup, width, height, band_row0=row0,
                             band_tile_rows=n_rows)
            for bins in (whole, local):
                tri, z, _, _ = R.rasterize(bins, width=width, height=h,
                                           tile_row_offset=row0, **kw)
                tri_p, z_p, _, _ = R._raster_plain(bins, width, h, mode,
                                                   row0)
                torch.cuda.synchronize()
                assert torch.equal(z, z_p), (mode, row0)
                assert torch.equal(z, z_w[y0: y0 + h]), (mode, row0)
                if mode == "slim":
                    assert torch.equal(tri, tri_p), (mode, row0)
                    assert torch.equal(tri, tri_w[y0: y0 + h]), (mode, row0)
                    covered += int((tri >= 0).sum())
    return covered


@pytest.mark.cuda
@pytest.mark.parametrize("n_bands", [1, 3, 5])
def test_band_raster_odd_band_counts(cuda, n_bands):
    """K1b/K2b: 15 bin rows cut into 1, 3 or 5 bands, every band start on
    a region's (and bin row's) border; then bands of one bin row and a
    last band cut short inside its bin row."""
    import numpy as np

    from mo_renderer_tpu_torch.kernels import raster_setup as RS

    width, height = 384, 15 * 32 - 11
    rng = np.random.default_rng(n_bands)
    n_tri = 600
    pts = rng.uniform([-8, -8], [width + 8, height + 8], size=(n_tri * 3, 2))
    binned = _binned_from_points(pts, rng.uniform(0.05, 0.95, n_tri * 3),
                                 width, height, cuda)
    setup = RS.TriangleSetup(binned.tri_data, binned.bbox)
    rows = 15 // n_bands
    bands = [(b * rows, rows) for b in range(n_bands)]
    assert _assert_bands_exact(setup, width, height, bands) > 0
    assert _assert_bands_exact(setup, width, height,
                               [(0, 1), (7, 1), (14, 1)]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_band_raster_near_plane_triangles_across_bands(cuda, seed):
    """Triangles with a corner right in front of the eye plane (edges far
    over MAX_EXACT_EXTENT, so binning gives them the box of their tiles)
    straddle the border of two bands of two bin rows each."""
    import numpy as np

    from mo_renderer_tpu_torch.kernels import raster_setup as RS

    width, height, n_tri = 384, 128, 300
    rng = np.random.default_rng(seed)
    ndc = rng.uniform(-1.2, 1.2, size=(n_tri, 3, 2))
    w = np.ones((n_tri, 3))
    w[:, 0] = np.exp(rng.uniform(np.log(1.1e-6), np.log(1e-3), size=n_tri))
    xy = ndc.copy()
    xy[:, 1:] *= w[:, 1:, None]
    z = rng.uniform(0.05, 0.95, size=(n_tri, 3)) * w
    clip = np.concatenate([xy, z[..., None], w[..., None]], -1)
    clip = torch.from_numpy(clip.reshape(-1, 4).astype(np.float32))
    idx = torch.arange(n_tri * 3, dtype=torch.int32).reshape(n_tri, 3)
    setup = RS.triangle_setup(clip, idx, torch.ones(n_tri, dtype=torch.bool),
                              width, height, cull_backface=False)
    setup.tri_data = setup.tri_data.to(cuda)
    setup.bbox = setup.bbox.to(cuda)
    huge = ~(setup.tri_data[:, :RS.COL_C0].abs().amax(1)
             <= RS.MAX_EXACT_EXTENT)
    live = (setup.tri_data[:, RS.COL_VALID] > 0) & (
        setup.bbox[:, 0] <= setup.bbox[:, 2])
    # some of them reach over the band border at row 64
    straddle = (huge & live & (setup.bbox[:, 1] < 64)
                & (setup.bbox[:, 3] >= 64))
    assert int(straddle.sum()) > 5
    assert _assert_bands_exact(setup, width, height, [(0, 2), (2, 2)]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("h_band,w,n_bands", [
    (16, 256, 4), (8, 1920, 3), (45, 1000, 2), (64, 1024, 4),
])
def test_ssao_halo_kernel_matches_plain_and_whole_image(cuda, h_band, w,
                                                        n_bands):
    """K4b: a plane cut into bands, each with its neighbours' rows as
    halos (edge rows replicated outside), against its plain version and
    the same rows of the whole-image kernel -- also with bands shorter
    than the halo (16 rows against 24, 8 against 32) and ragged ones."""
    import numpy as np

    from mo_renderer_tpu_torch.passes import ssao as S

    h = h_band * n_bands
    rng = np.random.default_rng(h * w)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = 0.985 + 0.01 * yy / h
    for _ in range(12):
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(4, 20)
        d = np.where((xx - cx) ** 2 + (yy - cy) ** 2 < r * r,
                     d - rng.uniform(0.002, 0.02), d)
    depth = torch.from_numpy(np.clip(d, 0.0, 1.0).astype(np.float32)).to(cuda)
    whole = S.ssao_pass_tiles(depth)
    hr = S.ssao_halo_rows(w)
    # rows -hr .. h + hr - 1 of the plane, edge rows replicated
    ext = torch.cat([depth[:1].expand(hr, w), depth,
                     depth[-1:].expand(hr, w)])
    for b in range(n_bands):
        y0 = b * h_band
        band = depth[y0: y0 + h_band]
        top = ext[y0: y0 + hr].contiguous()
        bottom = ext[y0 + hr + h_band: y0 + 2 * hr + h_band].contiguous()
        out = S.ssao_pass_tiles(band, row_offset=y0, y_halo=(top, bottom))
        plain = S._ssao_plain(band, S.NUM_LEVELS, y0, S.NEAR, S.FAR,
                              (top, bottom))
        torch.cuda.synchronize()
        assert torch.equal(out, plain), b
        assert torch.equal(out, whole[y0: y0 + h_band]), b
    assert whole.min().item() < 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("widths,slot_map,hw", [
    ([8, 8, 4], (0, 1, 2, 3, 4), (37, 51)),
    ([8], (-1, 0, -1, 1, -1), (64, 128)),
])
def test_stack_planes_kernel_matches_plain(cuda, widths, slot_map, hw):
    """K7 on random quad tables, any pixel count (no block constraint):
    exact against its plain version."""
    import numpy as np

    from mo_renderer_tpu_torch.kernels import stack_planes as SP

    rng = np.random.default_rng(sum(widths))
    n_rows = 500
    groups = [
        torch.from_numpy(rng.integers(0, 1 << 32, size=(n_rows, w),
                                      dtype=np.uint64)
                         .astype(np.uint32).view(np.int32)).to(cuda)
        for w in widths
    ]
    idx = torch.from_numpy(
        rng.integers(0, n_rows, size=hw).astype(np.int32)).to(cuda)
    fx, fy = (torch.from_numpy(rng.uniform(0, 1, size=hw).astype(np.float32))
              .to(cuda) for _ in range(2))
    spec, _ = SP.out_spec(slot_map, widths)
    k = SP._stack_planes_cuda(idx, fx, fy, groups, spec)
    p = SP._stack_planes_plain(idx, fx, fy, groups, spec)
    torch.cuda.synchronize()
    assert k.shape == (len(spec), *hw)
    assert torch.equal(k, p)


def _cb_case(h, wc, seed):
    """A shaded cb colour plane with out-of-range values and exact halves
    of an 8-bit step, and blocky full-resolution ids with speckle."""
    import numpy as np

    rng = np.random.default_rng(seed)
    color = rng.uniform(-0.2, 1.2, (h, wc, 3)).astype(np.float32)
    halves = (rng.integers(0, 255, (h, wc, 3)) + 0.5) / 255.0
    color = np.where(rng.random((h, wc, 3)) < 0.2, halves, color)
    ids = rng.integers(-1, 5, (h // 4 + 1, wc // 8 + 1)).astype(np.int32)
    tri = np.repeat(np.repeat(ids, 4, 0), 16, 1)[:h, : 2 * wc]
    tri = np.where(rng.random((h, 2 * wc)) < 0.05, 12, tri).astype(np.int32)
    return torch.from_numpy(color.astype(np.float32)), torch.from_numpy(tri)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("h,wc", [(1, 1), (2, 1), (9, 33), (17, 130),
                                  (1088, 960)])
def test_reconstruct_kernel_matches_plain(cuda, h, wc, fused):
    """K5, the packed entry and the one that takes the float colour, on
    planes of odd width, one row, a last strip of one lane, and the frame's
    own size: exact against the plain version."""
    from mo_renderer_tpu_torch.passes import checkerboard as CB
    from mo_renderer_tpu_torch.passes.present import present_pass

    color, tri = (a.to(cuda) for a in _cb_case(h, wc, h * wc))
    packed = present_pass(color)
    want = CB._reconstruct_plain(packed, tri)
    got = CB._reconstruct_cuda(color if fused else packed, tri)
    torch.cuda.synchronize()
    assert got.shape == (h, 2 * wc) and torch.equal(got, want)
    # the public entries take the same route
    public = (CB.reconstruct_present(color, tri) if fused
              else CB.reconstruct_full(packed, tri))
    assert torch.equal(public, want)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_reconstruct_kernel_unaligned_planes(cuda, fused):
    """An even width whose planes start 4 bytes off a 16-byte boundary:
    the kernel's element-wise path."""
    from mo_renderer_tpu_torch.passes import checkerboard as CB
    from mo_renderer_tpu_torch.passes.present import present_pass

    h, wc = 19, 70
    color, tri = (a.to(cuda) for a in _cb_case(h, wc, 3))

    def shifted(a):
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=cuda)
        buf[1:] = a.reshape(-1)
        return buf[1:].view(a.shape)

    packed = present_pass(color)
    want = CB._reconstruct_plain(packed, tri)
    cb = shifted(color if fused else packed)
    assert cb.data_ptr() % 16 == 4 and cb.is_contiguous()
    for tri_in in (tri, shifted(tri)):
        got = CB._reconstruct_cuda(cb, tri_in)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_entry_points_default_to_the_card(cuda):
    from mo_renderer_tpu_torch import App, Renderer, scenes

    cfg = scenes.tiny_config()
    assert Renderer(cfg).device.type == "cuda"
    assert App.new(config=cfg).device.type == "cuda"


@pytest.mark.cuda
def test_shading_kernel_holds_every_option_set(cuda):
    """K9 against its plain version at rtol 2e-3 / atol 1e-4 (the packed
    frame within 1 LSB on < 1% of pixels) on every knob set of the
    reference's budget matrix, the three PCF layouts, no IBL, no shadow
    and a band of the rows path, at 256x128 (chip_smoke's phase 2 runs
    them at 1080p)."""
    import chip_smoke
    from mo_renderer_tpu_torch import scenes

    n = chip_smoke.check_shading_options(scenes.tiny_config(), cuda)
    assert n == len(scenes.BUDGET_BOUNDS) + 5


def _shading_case(cuda, n_lights, cb, seed=0, sky=True):
    """A random G-buffer on the card (a quarter of it sky; none without
    ``sky``), random SSAO, lights and a PCF table, and the tiny scene's
    IBL: the arguments of the kernel and its plain version."""
    import numpy as np

    from mo_renderer_tpu_torch import scenes
    from mo_renderer_tpu_torch.device import sampling as S
    from mo_renderer_tpu_torch.passes.gbuffer import GBuffer

    rng = np.random.default_rng(seed)
    h, w = 36, 50  # an odd even-grid width; the plain version takes even sizes

    def plane(*shape, lo=0.0, hi=1.0):
        return torch.from_numpy(
            rng.uniform(lo, hi, shape).astype(np.float32)).to(cuda)

    normal = torch.nn.functional.normalize(plane(h, w, 3, lo=-1.0), dim=-1)
    depth = plane(h, w, lo=0.5, hi=1.33 if sky else 0.99).clamp(max=1.0)
    gbuf = GBuffer(base_color=plane(h, w, 3), position=plane(h, w, 3, lo=-2),
                   normal=normal, emissive=plane(h, w, 3, hi=0.1),
                   orm=plane(h, w, 3), velocity=plane(h, w, 2), depth=depth,
                   mask=depth < 1.0)
    lights = plane(n_lights + 1, 20)
    lights[:, 0] = torch.tensor([0.0, 1.0, 2.0] * 2, device=cuda)[
        :n_lights + 1]
    lights[:, 2] *= 20.0
    pv = torch.tensor([[0.3, 0.0, 0.1, 0.0], [0.0, 0.3, 0.0, 0.1],
                       [0.05, 0.02, 0.1, 0.5], [0.0, 0.0, 0.0, 1.0]],
                      device=cuda)
    params = {"eye_pos": torch.tensor([0.0, 1.0, -3.0], device=cuda),
              "light_proj_view": pv,
              "right": torch.tensor([1.0, 0.0, 0.0], device=cuda),
              "up": torch.tensor([0.0, 1.0, 0.0], device=cuda),
              "direction": torch.tensor([0.0, 0.0, 1.0], device=cuda),
              "near": torch.tensor(0.1, device=cuda),
              "near_wh": torch.tensor([0.2, 0.1], device=cuda)}
    rows = S.build_pcf_window_u16_half(plane(64, 64, lo=0.3, hi=0.9))
    ibl = scenes.tiny_ibl(cuda).maps()
    return (gbuf, plane(h, w, lo=0.5), rows, 64, lights, n_lights, params,
            ibl, 2, True, True, True, cb, 0, None)


@pytest.mark.cuda
@pytest.mark.parametrize("n_lights", [1, 5])
@pytest.mark.parametrize("cb", [False, True])
def test_shading_kernel_on_random_gbuffers(cuda, n_lights, cb):
    """K9 away from any frame: a random G-buffer whose even grid has an
    odd width, directional, point and spot lights, against the plain
    version at the bar."""
    import chip_smoke
    from mo_renderer_tpu_torch.passes import shading as Sh

    args = _shading_case(cuda, n_lights, cb)
    got = Sh._shading_fast_cuda(*args)
    want = Sh._shading_fast_plain(*args)
    torch.cuda.synchronize()
    err, ok, bar = chip_smoke.shading_compare(got, want)
    assert ok, (err, bar)


@pytest.mark.cuda
def test_shading_never_falls_back_on_the_card(cuda, monkeypatch):
    """A card G-buffer launches the kernel, once, and never the PyTorch
    ops; the full-rate mirror tap on the checkerboard raises, as the plain
    version does."""
    from mo_renderer_tpu_torch.kernels import _build
    from mo_renderer_tpu_torch.passes import shading as Sh

    args = _shading_case(cuda, 2, True)

    def plain(*a):
        raise AssertionError("the card ran the PyTorch ops")

    monkeypatch.setattr(Sh, "_shading_fast_plain", plain)
    before = _build.LAUNCHES["shading"]
    out = Sh.shading_pass_fast(*args[:7], ibl=args[7], shadow_res_divisor=2,
                               cb=True)
    torch.cuda.synchronize()
    assert out.is_cuda and _build.LAUNCHES["shading"] == before + 1
    with pytest.raises(NotImplementedError, match="spec_mirror_half_res"):
        Sh.shading_pass_fast(*args[:7], ibl=args[7], mirror_half_res=False,
                             cb=True)


@pytest.mark.cuda
@pytest.mark.parametrize("divisor", [2, 4])
@pytest.mark.parametrize("cb", [False, True])
def test_shading_even_grid_samples_match_plain(cuda, divisor, cb):
    """K9's even-grid samples, which stay in shared memory on the frame's
    path, through its debug planes: the table rows and sky flags equal the
    plain version's, the taps within the bar, no PCF sample a tap apart
    (tiles whose halo the next tile also evaluates: an odd even-grid
    width)."""
    import chip_smoke

    args = list(_shading_case(cuda, 2, cb))
    args[8] = divisor
    chip_smoke.shading_taps_check(tuple(args))
    torch.cuda.synchronize()


# (PCF divisor, spec_parent_mip_half_res, spec_mirror_half_res,
# spec_merged_trilinear): the sets that take a specular tap or the PCF at
# full rate, and the frame's own
FULL_RATE_KNOBS = [(1, False, False, False), (2, True, False, False),
                   (4, False, True, True), (1, True, True, False),
                   (2, False, False, False), (4, True, True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", FULL_RATE_KNOBS)
@pytest.mark.parametrize("sky", [False, True])
def test_shading_full_rate_choices_match_plain(cuda, knobs, sky):
    """K9 with ``debug`` on a random G-buffer with and without sky: every
    discrete choice it makes, on the even grid and at full rate (the
    full-rate taps' table rows, the environment row of a sky pixel, the
    mask-aware upsample's pick, the PCF window's anchor and factor at
    divisor 1), equals the plain version's."""
    import chip_smoke

    args = list(_shading_case(cuda, 3, False, sky=sky))
    args[8:12] = knobs
    res = chip_smoke.shading_taps_check(tuple(args))
    torch.cuda.synchronize()
    assert res["choices_apart"] == 0
    full_rate = knobs[0] == 1 or not (knobs[1] and knobs[2])
    assert any(k.startswith("full-rate") for k in res) == (full_rate or sky)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [None, (1, False, False), (1, True, False),
                                   (1, False, True)])
def test_shading_choices_on_a_sky_free_frame(cuda, knobs):
    """K9 on the tiny scene's 256x128 frame from scenes.tiny_lit_camera,
    where no pixel is sky: the frame's own call (``None``) and the
    full-rate knob sets of the budget matrix, 0 discrete choices apart."""
    import chip_smoke
    from mo_renderer_tpu_torch import scenes

    cfg = scenes.tiny_config() if knobs is None else scenes.budget_config(
        scenes.tiny_config(checkerboard=False, ssao_res_divisor=1), knobs)
    seen = chip_smoke.capture_inputs(
        cfg, cuda, [({}, scenes.tiny_world, scenes.tiny_lit_camera)],
        {"shading"})
    args = chip_smoke.shading_args(*seen["shading"])
    assert int((args[0].depth >= 1.0).sum()) == 0
    assert chip_smoke.shading_taps_check(args)["choices_apart"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("slot_map", [(0, 1, 2, 3, 4), (-1, 0, -1, 1, -1)])
@pytest.mark.parametrize("source", ["planes", "torch", "megakernel",
                                    "stacks", "band"])
def test_gbuffer_tail_kernel_matches_plain(cuda, source, slot_map):
    """K10 on random inputs laid out as each caller has them (views of
    planes, of gathered rows, the megakernel's planes with material ids
    to round, the stack_planes kernel's planes, a band's rows): every
    plane within rtol 2e-3 / atol 1e-4, the mask equal, no texel row
    apart from the plain version's."""
    import chip_smoke

    for seed in (0, 1):
        args = chip_smoke.random_tail_call(source, slot_map, cuda, seed=seed)
        err, ok, bar, rows = chip_smoke.gbuffer_check(args)
        torch.cuda.synchronize()
        assert ok, (seed, err, bar, rows)


@pytest.mark.cuda
def test_gbuffer_tail_never_falls_back_on_the_card(cuda, monkeypatch):
    """A card visibility plane launches K10, once a call, on every input
    source and on every fast path's frame, and never the PyTorch ops of
    the tail."""
    import chip_smoke
    from mo_renderer_tpu_torch import Renderer, scenes
    from mo_renderer_tpu_torch.kernels import _build
    from mo_renderer_tpu_torch.passes import gbuffer as GB

    def plain(*a, **k):
        raise AssertionError("the card ran the PyTorch ops")

    monkeypatch.setattr(GB, "_gbuffer_tail_plain", plain)
    monkeypatch.setattr(GB, "_texture_and_assemble", plain)
    for source in chip_smoke.GBUFFER_SOURCES:
        tri, z, src, pv, prev_pv, scene, slot_map, stack = \
            chip_smoke.random_tail_call(source, (0, 1, 2, 3, 4), cuda)
        before = _build.LAUNCHES["gbuffer"]
        g = GB.gbuffer_tail(tri, z, src, {"proj_view": pv,
                                          "prev_proj_view": prev_pv},
                            scene, slot_map, stack_kernel=stack)
        torch.cuda.synchronize()
        assert g.base_color.is_cuda and g.mask.dtype == torch.bool
        assert _build.LAUNCHES["gbuffer"] == before + 1, source
    for overrides, scene_kw in (
            ({}, {}), ({"attrs_plane_kernel": False}, {}),
            ({"raster_interp_attrs": True}, {}),
            ({"attrs_plane_kernel": False, "stack_plane_kernel": True},
             {"all_slots": True})):
        cfg = scenes.tiny_config(**overrides)
        world = scenes.tiny_world(**scene_kw)
        world.insert_resource(scenes.camera(cfg))
        r = Renderer(cfg, cuda)
        r.prepare(world)
        before = _build.LAUNCHES["gbuffer"]
        r.render(world)
        assert _build.LAUNCHES["gbuffer"] > before, overrides


# the sky patterns of _shading_ref_case: no pixel, every pixel, all but
# every 600th pixel, every other pixel, or depths drawn at random (about
# 40% of the pixels sky)
SKY_PATTERNS = ("none", "all", "one", "alternate", "random")


def _shading_ref_case(cuda, n_lights, seed=0, ibl=True, shadow=True,
                      sky="random", width=None):
    """A random G-buffer on the card (its sky pixels one of SKY_PATTERNS,
    normals on cube diagonals in its first row), random SSAO, ``n_lights``
    lights of the three kinds, a raw 64 x 64 shadow map and the tiny
    scene's IBL maps: the arguments of K11 and its plain version.  Against
    the kernel's spans of up to 512 pixels the patterns give spans with
    no lit pixel, one, every other one, all lit, and a ragged last span;
    ``width``: the planes, depth and SSAO are views of their first
    ``width`` columns, so a span wraps over rows of strided views."""
    import dataclasses

    import numpy as np

    from mo_renderer_tpu_torch import scenes
    from mo_renderer_tpu_torch.passes.gbuffer import GBuffer

    rng = np.random.default_rng(seed)
    h, w = 37, 70  # ragged against the kernel's spans

    def plane(*shape, lo=0.0, hi=1.0):
        return torch.from_numpy(
            rng.uniform(lo, hi, shape).astype(np.float32)).to(cuda)

    normal = plane(h, w, 3, lo=-1.0)
    normal[0, :4] = torch.tensor([[1.0, 1.0, 0.0], [-1.0, 1.0, 1.0],
                                  [0.0, -1.0, -1.0], [1.0, 0.0, -1.0]],
                                 device=cuda)
    normal = torch.nn.functional.normalize(normal, dim=-1)
    depth = plane(h, w, lo=0.5, hi=1.33).clamp(max=1.0)
    if sky == "none":
        depth = depth.clamp(max=0.99)
    elif sky == "all":
        depth = torch.ones_like(depth)
    elif sky in ("one", "alternate"):
        idx = torch.arange(h * w, device=cuda).reshape(h, w)
        lit = idx % (600 if sky == "one" else 2) == 0
        depth = torch.where(lit, depth.clamp(max=0.99), 1.0)
    orm = plane(h, w, 3)
    orm[1, :8, 1] = torch.arange(8, device=cuda) / 7.0  # the mip boundaries
    gbuf = GBuffer(base_color=plane(h, w, 3), position=plane(h, w, 3, lo=-2),
                   normal=normal, emissive=plane(h, w, 3, hi=0.1), orm=orm,
                   velocity=plane(h, w, 2), depth=depth, mask=depth < 1.0)
    lights = plane(n_lights, 20)
    lights[:, 0] = torch.arange(n_lights, device=cuda) % 3
    lights[:, 2] *= 20.0
    pv = torch.tensor([[0.3, 0.0, 0.1, 0.0], [0.0, 0.3, 0.0, 0.1],
                       [0.05, 0.02, 0.1, 0.5], [0.0, 0.0, 0.0, 1.0]],
                      device=cuda)
    params = {"eye_pos": torch.tensor([0.0, 1.0, -3.0], device=cuda),
              "light_proj_view": pv,
              "right": torch.tensor([1.0, 0.0, 0.0], device=cuda),
              "up": torch.tensor([0.0, 1.0, 0.0], device=cuda),
              "direction": torch.tensor([0.0, 0.0, 1.0], device=cuda),
              "near": torch.tensor(0.1, device=cuda),
              "near_wh": torch.tensor([0.2, 0.1], device=cuda)}
    ssao = plane(h, w, lo=0.5)
    smap = plane(64, 64, lo=0.3, hi=0.9) if shadow else None
    if width is not None:
        for f in dataclasses.fields(gbuf):
            setattr(gbuf, f.name, getattr(gbuf, f.name)[:, :width])
        ssao = ssao[:, :width]
    return (gbuf, ssao, smap, lights, n_lights, params,
            scenes.tiny_ibl(cuda).maps() if ibl else None)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [None, 1, 33])
@pytest.mark.parametrize("sky", SKY_PATTERNS)
@pytest.mark.parametrize("n_lights", [1, 3, 16])
@pytest.mark.parametrize("ibl,shadow", [(True, True), (False, True),
                                        (True, False), (False, False)])
def test_shading_ref_kernel_on_random_gbuffers(cuda, n_lights, ibl, shadow,
                                               sky, width):
    """K11 away from any frame, under every option set and sky pattern
    (so spans with 0, some or all of their pixels lit), on the whole
    G-buffer and on narrow column views of it: the colour at the bar, and
    no PCF tap, tap texel, cube face, mip level or sample texel apart from
    the plain version's (through its debug output)."""
    import chip_smoke

    args = _shading_ref_case(cuda, n_lights, ibl=ibl, shadow=shadow,
                             sky=sky, width=width)
    err, ok, bar, apart = chip_smoke.shading_ref_check(args)
    torch.cuda.synchronize()
    assert ok, (err, bar, apart)


def _light_table(cuda, n_rows, seed=1):
    """``n_rows`` random GpuLight rows of the three kinds, as the random
    cases draw them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lights = torch.from_numpy(
        rng.uniform(0.0, 1.0, (n_rows, 20)).astype(np.float32)).to(cuda)
    lights[:, 0] = torch.arange(n_rows, device=cuda) % 3
    lights[:, 2] *= 20.0
    return lights


def _behind_dark_rows(lights, n_dark):
    """``lights`` behind ``n_dark`` point lights of no colour, which add
    exactly +0 to the sum they start (a point light's radiance is its
    colour times a finite attenuation)."""
    dark = torch.zeros(n_dark, lights.shape[1], device=lights.device)
    dark[:, 0] = 1.0
    dark[:, 4:7] = torch.arange(n_dark, device=lights.device)[:, None] * 0.01
    dark[:, 16:19] = torch.tensor([1.0, 0.09, 0.032], device=lights.device)
    return torch.cat([dark, lights])


# K9 (shading) and K11 (shading_ref): (kernel, plain version, the random
# case of n light rows, where the case's light rows and count sit)
def _shading_kernel_case(cuda, kernel, n_rows):
    from mo_renderer_tpu_torch.passes import shading as Sh

    if kernel == "shading":
        args, at = list(_shading_case(cuda, 1, True)), 4
        fns = Sh._shading_fast_cuda, Sh._shading_fast_plain
    else:
        args, at = list(_shading_ref_case(cuda, 1)), 3
        fns = Sh._shading_ref_cuda, Sh._shading_ref_plain
    args[at], args[at + 1] = _light_table(cuda, n_rows), n_rows
    return fns, args, at


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [5, 538, 539, 1025])
@pytest.mark.parametrize("kernel", ["shading", "shading_ref"])
def test_shading_kernels_take_a_light_table_of_any_length(cuda, kernel,
                                                          n_rows):
    """K9 and K11 on a random G-buffer lit by ``n_rows`` light rows -- at
    most one chunk of the shared memory (``shading.LIGHT_CHUNK_ROWS``,
    the table loaded whole), one row past it, two chunks (the table
    streamed) -- against the plain version at the bar.  Behind dark rows
    that start it at two places against the chunk borders, a table
    streams to the same bytes, and those of a table already streamed."""
    import chip_smoke
    from mo_renderer_tpu_torch.passes import shading as Sh

    (kern, plain), args, at = _shading_kernel_case(cuda, kernel, n_rows)
    got = kern(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err, ok, bar = chip_smoke.shading_compare(got, want)
    assert ok, (err, bar)
    lights = args[at]
    streamed = []
    for n_dark in (Sh.LIGHT_CHUNK_ROWS + 1, Sh.LIGHT_CHUNK_ROWS * 3 // 2):
        args[at] = _behind_dark_rows(lights, n_dark)
        args[at + 1] = n_rows + n_dark
        streamed.append(kern(*args))
    assert torch.equal(streamed[0], streamed[1])
    if n_rows > Sh.LIGHT_CHUNK_ROWS:
        assert torch.equal(streamed[0], got)


@pytest.mark.cuda
def test_shading_ref_holds_its_option_sets(cuda):
    """K11 on the frames' own calls at 256x128: no IBL, no shadow, the
    UV1 scene under default flags, a sun, a point and a spot light."""
    import chip_smoke
    from mo_renderer_tpu_torch import scenes

    assert chip_smoke.check_shading_ref_options(scenes.tiny_config(),
                                                cuda) == 4


@pytest.mark.cuda
def test_shading_ref_never_falls_back_on_the_card(cuda, monkeypatch):
    """A card G-buffer launches K11 once a call under every option set,
    and on the reference frame, never the PyTorch ops; a float64 plane
    raises."""
    from mo_renderer_tpu_torch import Renderer, scenes
    from mo_renderer_tpu_torch.kernels import _build
    from mo_renderer_tpu_torch.passes import shading as Sh

    def plain(*a, **k):
        raise AssertionError("the card ran the PyTorch ops")

    monkeypatch.setattr(Sh, "_shading_ref_plain", plain)
    for ibl in (True, False):
        for shadow in (True, False):
            args = _shading_ref_case(cuda, 3, ibl=ibl, shadow=shadow)
            before = _build.LAUNCHES["shading_ref"]
            out = Sh.shading_pass(*args[:6], ibl=args[6])
            torch.cuda.synchronize()
            assert out.is_cuda and out.shape == (37, 70, 3)
            assert _build.LAUNCHES["shading_ref"] == before + 1
    args = _shading_ref_case(cuda, 3)
    with pytest.raises(ValueError, match="float32"):
        Sh.shading_pass(args[0], args[1].double(), *args[2:6], ibl=args[6])
    cfg = scenes.tiny_config(fast_sampling=False)
    world = scenes.tiny_world()
    world.insert_resource(scenes.camera(cfg))
    r = Renderer(cfg, cuda)
    r.prepare(world)
    before = _build.LAUNCHES["shading_ref"]
    r.render(world)
    assert _build.LAUNCHES["shading_ref"] > before


@pytest.mark.cuda
@pytest.mark.parametrize("case", [{}, {"slot_uv": 0.0}, {"slot_uv": 1.0},
                                  {"tangent": True}, {"tangent": False}])
@pytest.mark.parametrize("shape", [(24, 32, 8), (37, 70, 64), (13, 45, 6),
                                   (33, 129, 16)])
def test_gbuffer_ref_kernel_matches_plain(cuda, case, shape):
    """K12 away from any frame, on random scenes aimed at its
    discontinuities (texel centres and their ulps, REPEAT both ways, each
    UV set, has_tangent both ways, the |qs| guard, uncovered pixels;
    targets ragged against the kernel's 32-pixel spans and its 4-float
    vectors, odd in H and W; a 6 x 6 texture, whose REPEAT wrap takes the
    integer remainder, not the power-of-two mask): every plane at
    rtol 2e-3 / atol 1e-4, the mask equal, no texel anchor or UV set apart
    from the plain version's."""
    import chip_smoke

    h, w, size = shape
    for seed in (0, 1):
        args = chip_smoke.ref_call(chip_smoke.random_ref_inputs(
            seed, h=h, w=w, size=size, **case), cuda)
        err, ok, bar, apart = chip_smoke.gbuffer_ref_check(args)
        torch.cuda.synchronize()
        assert ok, (seed, err, bar, apart)


@pytest.mark.cuda
def test_gbuffer_ref_holds_its_option_sets(cuda):
    """K12 on the frames' own calls at 256x128: the UV1 scene under default
    flags, the all-slots scene, that call without tangents, and the grid
    seen from lit_camera cut to an odd 119x253 target."""
    import chip_smoke
    from mo_renderer_tpu_torch import scenes

    assert chip_smoke.check_gbuffer_ref_options(scenes.tiny_config(),
                                                cuda) == 4


@pytest.mark.cuda
def test_gbuffer_ref_never_falls_back_on_the_card(cuda, monkeypatch):
    """A card visibility buffer launches K12 once a call, and the
    reference frame launches it, never the PyTorch ops; a float64
    barycentric plane raises."""
    import chip_smoke
    from mo_renderer_tpu_torch import Renderer, scenes
    from mo_renderer_tpu_torch.kernels import _build
    from mo_renderer_tpu_torch.passes import gbuffer as GB

    def plain(*a, **k):
        raise AssertionError("the card ran the PyTorch ops")

    monkeypatch.setattr(GB, "_gbuffer_ref_plain", plain)
    args = chip_smoke.ref_call(chip_smoke.random_ref_inputs(), cuda)
    before = _build.LAUNCHES["gbuffer_ref"]
    g = GB.gbuffer_pass(*args)
    torch.cuda.synchronize()
    assert g.base_color.is_cuda and g.mask.dtype == torch.bool
    assert g.depth is args[1]
    assert _build.LAUNCHES["gbuffer_ref"] == before + 1
    with pytest.raises(ValueError, match="b0"):
        GB.gbuffer_pass(args[0], args[1], args[2].double(), *args[3:])
    cfg = scenes.tiny_config(fast_sampling=False)
    world = scenes.tiny_world()
    world.insert_resource(scenes.camera(cfg))
    r = Renderer(cfg, cuda)
    r.prepare(world)
    before = _build.LAUNCHES["gbuffer_ref"]
    r.render(world)
    assert _build.LAUNCHES["gbuffer_ref"] > before


def _pinned_root(frame):
    """The tensor a fetched frame's byte view keeps alive."""
    import numpy as np

    while isinstance(frame, np.ndarray):
        frame = frame.base
    return frame


def _turn(world, cfg, angle):
    from mo_renderer_tpu_torch import scenes
    from mo_renderer_tpu_torch.scene.camera import Camera

    cam, pose = world.resource(Camera), scenes.camera(cfg, angle)
    cam.transform.translation = pose.transform.translation
    cam.transform.rotation = pose.transform.rotation
    cam.refresh_view()


@pytest.mark.cuda
def test_a_capture_runs_with_the_collector_off(cuda, monkeypatch):
    """Python's cyclic collector makes no automatic pass while a frame is
    captured, and is on again after: a pass inside the capture may free
    an older renderer's graph, and destroying a graph while a stream
    captures invalidates the capture (which pass lands there depends on
    every allocation before it, so this file's earlier tests decide)."""
    import gc

    from mo_renderer_tpu_torch import Renderer, scenes
    from mo_renderer_tpu_torch.passes import frame_graph as FG

    seen = []
    program = FG.frame_program

    def spy(*args, **kwargs):
        seen.append((torch.cuda.is_current_stream_capturing(),
                     gc.isenabled()))
        return program(*args, **kwargs)

    monkeypatch.setattr(FG, "frame_program", spy)
    assert gc.isenabled()
    cfg = scenes.tiny_config()
    world = scenes.tiny_world()
    world.insert_resource(scenes.camera(cfg))
    r = Renderer(cfg, cuda)
    r.prepare(world)
    r.render(world)
    assert (True, False) in seen and (True, True) not in seen
    assert (False, True) in seen  # the eager run before the capture
    assert gc.isenabled()


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["default", "reference", "megakernel"])
def test_render_fetches_through_pinned_memory(cuda, path, monkeypatch):
    """``Renderer.render`` on the card: its array equals the byte view of
    ``render_device(...).cpu()`` bit for bit and views a pinned tensor; a
    held frame survives 8 later frames; ``fetch_pinned`` counts one a
    frame and ``fetch_bytes`` H*W*4; the counts reach ``check_overflow``
    already in pinned host memory; ``fetch`` splits into ``fetch_issue``
    and ``fetch_wait``; 50 dropped frames reuse a few host buffers."""
    import numpy as np

    import chip_smoke
    from mo_renderer_tpu_torch import Renderer, scenes
    from mo_renderer_tpu_torch.utils import trace

    cfg = scenes.tiny_config(**chip_smoke.PATHS[path][0])
    world = scenes.tiny_world()
    world.insert_resource(scenes.camera(cfg))
    r = Renderer(cfg, cuda)
    r.prepare(world)
    r.render(world)  # the captures
    h, w = cfg.height, cfg.width

    before = trace.snapshot()["counters"]
    frame = r.render(world)
    after = trace.snapshot()["counters"]
    assert after["fetch_pinned"] - before.get("fetch_pinned", 0) == 1
    assert after["fetch_bytes"] - before.get("fetch_bytes", 0) == h * w * 4
    want = r.render_device(world).cpu().numpy()
    r.check_overflow()
    want = want.view(np.uint8).reshape(h, w, 4)
    assert frame.shape == (h, w, 4) and frame.dtype == np.uint8
    np.testing.assert_array_equal(frame, want)
    root = _pinned_root(frame)
    assert torch.is_tensor(root) and root.is_pinned()

    held = frame.copy()
    later = []
    for k in range(1, 9):
        _turn(world, cfg, 0.2 * k)
        later.append(r.render(world))
    np.testing.assert_array_equal(frame, held)
    assert not np.array_equal(later[-1], held)  # the camera moved
    assert all(not np.shares_memory(frame, f) for f in later)

    seen = []
    check = r.check_overflow

    def spy():
        seen.append([(v.device.type, v.is_pinned())
                     for v in r._pending_overflow])
        check()

    monkeypatch.setattr(r, "check_overflow", spy)
    _turn(world, cfg, 0.0)
    r.render(world)
    assert seen and seen[-1] and all(s == ("cpu", True) for s in seen[-1])
    monkeypatch.undo()

    n0 = len(trace.snapshot()["spans"])
    trace.enable()
    try:
        r.render(world)
    finally:
        trace.disable()
    spans = trace.snapshot()["spans"][n0:]
    fetch = next(i for i, s in enumerate(spans) if s[0] == "fetch")
    assert [s[0] for s in spans if s[1] == n0 + fetch] == [
        "fetch_issue", "fetch_wait"]

    ptrs = set()
    for k in range(50):
        _turn(world, cfg, 0.05 * k)
        ptrs.add(_pinned_root(r.render(world)).data_ptr())
    assert len(ptrs) <= 4, len(ptrs)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["default", "reference"])
def test_replayed_walk_copies_its_block_from_pinned_memory(cuda, path):
    """20 frames of a walk over ``grid_world(10)`` replayed on the card:
    each frame's camera block is the numpy construction's bytes
    (``_plain_block`` of ``tests/test_torch_host_checks.py``), written into
    page-locked memory and copied from there into the graph's input, with
    no device vector made (one upload a frame); the frame equals the same
    graph replayed from that construction uploaded as before (a pageable
    upload, then a device copy) bit for bit; a frame held across the next
    ``render_device`` is not overwritten; and the walk builds one block a
    frame, no bake and no key."""
    import numpy as np

    import chip_smoke
    from mo_renderer_tpu_torch import Renderer, scenes
    from mo_renderer_tpu_torch.math import quat
    from mo_renderer_tpu_torch.scene.camera import Camera
    from mo_renderer_tpu_torch.scene.scene_buffers import find_shadow_light
    from mo_renderer_tpu_torch.utils import trace
    from test_torch_host_checks import _plain_block

    cfg = scenes.tiny_config(width=256, height=128,
                             **chip_smoke.PATHS[path][0])
    world = scenes.grid_world(10)
    world.insert_resource(scenes.grid_camera(cfg))
    cam = world.resource(Camera)
    base_pos = cam.transform.translation.copy()
    base_rot = cam.transform.rotation.copy()
    r = Renderer(cfg, cuda)
    r.prepare(world)
    r.render_device(world)  # the captures
    r.check_overflow()

    def counts():
        got = trace.snapshot()["counters"]
        return [got.get(k, 0) for k in ("camera_block_builds",
                                        "transform_bakes",
                                        "graph_key_builds")]

    start, captures = counts(), r._captures
    held = None
    for k in range(1, 21):
        cam.transform.translation = (base_pos + np.float32(
            [0.05 * k, 0.0, -0.03 * k])).astype(np.float32)
        cam.transform.rotation = quat.mul(
            quat.from_rotation_y(0.02 * k), base_rot)
        cam.refresh_view()
        frame = r.render_device(world)
        params, graph = r._params_prev, r._graph
        plain = _plain_block(cam, find_shadow_light(world)[0])
        assert params.host.tobytes() == plain.tobytes()
        assert params.src.is_pinned() and params._vec is None
        assert graph.input.src is params.src
        assert graph.input.buf.cpu().numpy().tobytes() == plain.tobytes()
        if held is not None:
            assert torch.equal(held[0], held[1])
        graph.replay(torch.from_numpy(plain).to(cuda))
        assert torch.equal(frame, graph.out)
        held = (frame, frame.clone())
    r.check_overflow()
    assert r._captures == captures
    assert [b - a for a, b in zip(start, counts())] == [20, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["default", "reference", "megakernel"])
def test_overflow_raises_on_its_frame_on_the_card(cuda, path):
    """Under a pair capacity of 720 the tiny scene's 515 pairs fit; a
    sphere spawned in view brings 943, and the frame after the spawn
    raises with the drained counts in its message."""
    import chip_smoke
    from mo_renderer_tpu_torch import Renderer, scenes
    from mo_renderer_tpu_torch.assets.procedural import procedural_model
    from mo_renderer_tpu_torch.math.transform import Transform

    cfg = scenes.tiny_config(binned_cap=720, shadow_enabled=False,
                             **chip_smoke.PATHS[path][0])
    world = scenes.tiny_world()
    world.insert_resource(scenes.camera(cfg))
    r = Renderer(cfg, cuda)
    r.prepare(world)
    for _ in range(2):
        r.render(world)
    world.spawn((Transform.from_xyz(0.6, 0.5, 0.6),
                 procedural_model("sphere")))
    with pytest.raises(RuntimeError, match=(
            r"rasterizer bin overflow: 223 G-buffer and 0 shadow \(tile, "
            r"triangle\) pairs dropped .* \(current 720\)")):
        r.render(world)
    assert r._pending_overflow == []


_SETUP_CASES = {}


def _setup_binning(case):
    """chip_smoke.check_setup_binning on one case, untimed; the cases'
    scenes are built once for the module."""
    import chip_smoke

    if not _SETUP_CASES:
        _SETUP_CASES.update(chip_smoke.check_setup_binning(
            "cuda", timing=False))
    return _SETUP_CASES[case]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["frame@1080p", "shadow@2048",
                                  "reference@1080p", "frame@4k",
                                  "band@1080p", "capped@1080p"])
def test_setup_binning_kernels_match_plain(cuda, case):
    """tri_setup_kernel and the binning kernels against the torch ops on
    the card, bit for bit (rows, boxes, runs, dropped counts), on
    scenes.grid_world(10): the 1080p frame from the packed
    corners, the 2048^2 light view (shadow bias, no cull), the reference
    path's clip through the indices, the 4K frame, a band, and a
    capacity below the pair count."""
    res = _setup_binning(case)
    assert res["bit_equal"] and res["pairs_listed"] > 0
    assert (res["dropped"] > 0) == (case == "capped@1080p")


@pytest.mark.cuda
@pytest.mark.parametrize("case,seed", [
    (case, seed) for case in ("below_cap", "past_cap", "band")
    for seed in (5, 6)])
def test_binning_contract_on_the_card(cuda, case, seed):
    """tests/test_torch_binning_contract.py's checks on the kernels."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "test_torch_binning_contract.py")
    spec = importlib.util.spec_from_file_location("binning_contract", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.check_contract(case, seed, cuda)


@pytest.mark.cuda
def test_replayed_walk_frame_bins_through_the_kernels(cuda):
    """A replayed 1080p frame of scenes.grid_world(10) (the shadow
    memoized): one launch of each setup and binning kernel a tiling in
    the frame's graph and in the shadow's, one more of each a replay,
    and no radix sort on the device."""
    from mo_renderer_tpu_torch import Renderer, scenes
    from mo_renderer_tpu_torch.config import EngineConfig
    from mo_renderer_tpu_torch.kernels import _build

    names = ("tri_setup", "bin_count", "bin_scan", "bin_fill")
    cfg = EngineConfig(width=1920, height=1080)
    world = scenes.grid_world(10)
    world.insert_resource(scenes.grid_camera(cfg))
    r = Renderer(cfg, cuda)
    r.prepare(world)
    for _ in range(2):
        r.render_device(world)
    for graph in (r._graph, r._shadow_graph):
        assert {k: graph.launches.get(k) for k in names} == dict.fromkeys(
            names, 1)
    before = dict(_build.LAUNCHES)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        r.render_device(world)
        torch.cuda.synchronize()
    assert {k: _build.LAUNCHES[k] - before[k] for k in names} == (
        dict.fromkeys(names, 1))
    ran = [row.key for row in prof.key_averages()
           if row.device_type == torch.autograd.DeviceType.CUDA]
    assert not [k for k in ran if "RadixSort" in k], ran
    assert any("bin_fill_kernel" in k for k in ran), ran
