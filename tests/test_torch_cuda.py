"""Card-only checks of the PyTorch port's CUDA kernels.

Marked ``cuda``; they skip where no CUDA device is present (the CPU
suite).  This file imports no ``jax``, so it also runs where jax is not
installed; ``tests/conftest.py`` imports jax, so run it there without
the conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

``python3 chip_smoke.py`` runs the same checks at 1920x1080.  The
random soups below hold the full-mode raster (K6) and the megakernel (K8)
to their plain versions away from the frame's own inputs.
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
    """Every kernel against its plain version on the 256x128 frame's own
    inputs (chip_smoke's phase 2 at the small size)."""
    import chip_smoke
    from mo_renderer_tpu_torch import scenes

    results = chip_smoke.check_kernels(scenes.tiny_config(), cuda)
    assert set(results) == set(chip_smoke.KERNELS)


@pytest.mark.cuda
def test_card_frame_matches_cpu_frame(cuda):
    """The 256x128 frames of the three paths and the UV1 scene."""
    import chip_smoke

    chip_smoke.check_small_frames(cuda)


def _soup_binned(seed, n_tri, width, height, extra_cols=0, device="cpu"):
    """Random triangles through the port's own setup and binning, with
    ``extra_cols`` random megakernel columns (1/w corners in (0.2, 2))."""
    import numpy as np

    from mo_renderer_tpu_torch.kernels import raster_setup as RS
    from mo_renderer_tpu_torch.kernels import rasterizer as R

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
    return RS.bin_triangles(
        setup, tile_h=R.BIN_H, tile_w=R.BIN_W,
        n_tiles_x=-(-width // R.BIN_W), n_tiles_y=-(-height // R.BIN_H),
    )


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

    binned = _soup_binned(seed, 400, 640, 200, RA_EXTRA_COLS, device=cuda)
    tri_k, z_k, planes_k = R._raster_attrs_cuda(binned, 640, 200)
    tri_p, z_p, planes_p = R._raster_attrs_plain(binned, 640, 200)
    assert torch.equal(tri_k, tri_p) and torch.equal(z_k, z_p)
    assert torch.equal(planes_k[R.N_INTERP:], planes_p[R.N_INTERP:])
    assert torch.allclose(planes_k, planes_p, rtol=2e-3, atol=1e-4)


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


@pytest.mark.cuda
def test_entry_points_default_to_the_card(cuda):
    from mo_renderer_tpu_torch import App, Renderer, scenes

    cfg = scenes.tiny_config()
    assert Renderer(cfg).device.type == "cuda"
    assert App.new(config=cfg).device.type == "cuda"
