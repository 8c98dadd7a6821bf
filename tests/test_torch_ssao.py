"""The port's SSAO tile pass (passes/ssao.py ssao_pass_tiles, the plain
version of csrc/ssao.cu) against the reference's ssao_pass_pallas, whose
Pallas kernel runs in interpret mode on the CPU.

Bar (tests/test_ssao.py:56-57): within 1.01/255, on fewer than 0.2% of
pixels — widened for a measured, explained residue.  The two sides agree
on the noise argument bit for bit (the port fuses the multiply-adds XLA
fuses and multiplies by the reciprocals XLA folds), but the reference's
f32 ``sin`` differs from the correctly rounded value by one ulp on ~1.3%
of pixels (measured with XLA:CPU at 576x1024), which moves the radius by
up to ~0.02 px.  Where that crosses a radius-level edge at an occlusion
boundary, the pixel takes the neighbouring level's taps: measured, 2 of
36864 pixels at 96x384 and 10 of 589824 at 576x1024, by up to 11/255.
So: at most 0.2% of pixels differ at all, and at most 0.02% by more than
1.01/255.  The tests print the measured shares.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mo_renderer_tpu.passes import ssao as JS  # noqa: E402
from mo_renderer_tpu_torch.passes import ssao as S  # noqa: E402


def _synthetic_depth(h, w, seed):
    """Plane-ish depth with a step edge and a bump (tests/test_ssao.py)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    d = 0.96 + 0.02 * yy
    d = np.where(xx > 0.5, d - 0.005, d)
    d = d - 0.004 * np.exp(-(((xx - 0.25) ** 2 + (yy - 0.5) ** 2) / 0.01))
    d += rng.normal(0, 1e-5, (h, w))
    return np.clip(d, 0.0, 1.0).astype(np.float32)


def _scene_depth(h, w, seed):
    """Piecewise planes at scene-like depths with sky (d = 1) patches."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = 0.985 + 0.01 * yy / h
    for _ in range(6):
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(6, 24)
        inside = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        d = np.where(inside, d - rng.uniform(0.002, 0.02), d)
    d[: h // 8] = 1.0
    return np.clip(d, 0.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("h,w,seed,kind", [
    (32, 256, 3, "synthetic"), (64, 128, 5, "synthetic"),
    (64, 256, 1, "scene"), (96, 384, 2, "scene"),
])
def test_ssao_tiles_match_reference(h, w, seed, kind):
    depth = (_synthetic_depth if kind == "synthetic" else _scene_depth)(
        h, w, seed
    )
    ref = np.asarray(
        jax.jit(lambda d: JS.ssao_pass_pallas(d, tile_h=16, tile_w=128))(
            jnp.asarray(depth)
        )
    )
    got = S.ssao_pass_tiles(torch.from_numpy(depth)).numpy()
    assert ref.min() < 0.99  # the scene occludes somewhere
    _assert_ssao_bar(got, ref, f"{kind} {h}x{w}")


def _assert_ssao_bar(got, ref, what):
    diff = np.abs(got - ref)
    frac = (diff > 0).mean()
    far = (diff > 1.01 / 255.0).mean()
    print(f"{what}: max |diff| {diff.max() * 255:.2f}/255, {frac:.4%} of "
          f"pixels differ, {far:.4%} by more than 1.01/255")
    assert frac < 0.002
    assert far < 0.0002


def test_ssao_output_is_quantized():
    ao = S.ssao_pass_tiles(torch.from_numpy(_synthetic_depth(48, 128, 0)))
    ao = ao.numpy()
    assert np.allclose(ao * 255.0, np.round(ao * 255.0), atol=1e-4)


def test_row_offset_moves_the_noise_like_the_reference():
    depth = _scene_depth(32, 128, 4)
    ref = np.asarray(JS.ssao_pass_pallas(
        jnp.asarray(depth), tile_h=16, tile_w=128, row_offset=48
    ))
    got = S.ssao_pass_tiles(torch.from_numpy(depth), row_offset=48).numpy()
    _assert_ssao_bar(got, ref, "row offset 48")


def test_ssao_frame_sized_matches_reference():
    """The default 1080p frame's SSAO shape: the 544x960 even grid padded
    to 576x1024 (the padded width enters the radius formula)."""
    depth = _scene_depth(576, 1024, 7)
    ref = np.asarray(jax.jit(
        lambda d: JS.ssao_pass_pallas(d, tile_h=64, tile_w=128)
    )(jnp.asarray(depth)))
    got = S.ssao_pass_tiles(torch.from_numpy(depth)).numpy()
    _assert_ssao_bar(got, ref, "576x1024")


def test_noise_and_linear_depth_match_reference():
    """The hash noise and the linearisation, elementwise: the noise
    argument is bit-exact, so the noise differs only through ulp-level
    sin differences (|dn| <= 0.004 * 43758 * 2 ulp(1))."""
    h, w = 96, 1024
    iy, ix = np.mgrid[0:h, 0:w].astype(np.float32)
    n_ref, _ = jax.jit(JS._noise)(jnp.asarray(ix), jnp.asarray(iy))
    n_got = S._noise(torch.from_numpy(ix), torch.from_numpy(iy)).numpy()
    bound = 0.004 * 43758.5453 * 2 * np.finfo(np.float32).eps
    dn = np.abs(n_got - np.asarray(n_ref))
    print(f"noise: {(dn > 0).mean():.4%} differ, max {dn.max():.3g} "
          f"(bound {bound:.3g})")
    assert dn.max() <= bound
    d = np.linspace(0.0, 1.0, 4097, dtype=np.float32)
    lin_ref = np.asarray(jax.jit(JS._linear_depth)(jnp.asarray(d)))
    lin = S._linear_depth(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(lin, lin_ref)


def test_tap_table_is_the_reference_table():
    for w in (128, 960, 1024, 1920):
        e_r, taps_r, m_r = JS._ssao_tap_table(w, 16)
        e, taps, m = S._ssao_tap_table(w, 16)
        np.testing.assert_array_equal(e, e_r)
        assert taps == taps_r and m == m_r


@pytest.mark.parametrize("w", [128, 1024, 1920])
def test_window_offsets_reproduce_the_plain_taps(w):
    """The CUDA kernel reads its taps at ``center + win_offs[level, tap]``
    inside a shared window of edge-clamped linear depth, ``win_w`` wide.
    Rebuilt here with torch indexing, that read returns, tap for tap, the
    sample ``_ssao_plain`` takes at (y + oy, x + ox) clamped to the image:
    on the first, a middle and the last (ragged) tile of a 48-row plane."""
    h = 48
    tile_h, tile_w = S.TILE_H, S.TILE_W
    tab = S._tables(w, S.NUM_LEVELS, torch.device("cpu"))
    halo = tab.max_off
    assert tab.win_w == tile_w + 2 * halo
    assert tab.win_offs.shape == (S.NUM_LEVELS, len(S._TAPS))
    d_lin = S._linear_depth(torch.from_numpy(_scene_depth(h, w, 9)))
    rw, _ = S._radii(d_lin, w, h)
    lvl = (rw[..., None] > tab.edges).sum(-1)
    assert lvl.unique().numel() > 1
    last_x = (w - 1) // tile_w * tile_w
    for y0, x0 in ((0, 0), (0, last_x // 2 // tile_w * tile_w),
                   (tile_h, last_x)):
        rows = torch.clamp(torch.arange(y0 - halo, y0 + tile_h + halo),
                           0, h - 1)
        cols = torch.clamp(torch.arange(x0 - halo, x0 + tile_w + halo),
                           0, w - 1)
        win = d_lin[rows][:, cols].reshape(-1)
        ys = torch.arange(y0, min(y0 + tile_h, h))[:, None]
        xs = torch.arange(x0, min(x0 + tile_w, w))[None, :]
        center = (ys - y0 + halo) * tab.win_w + (xs - x0 + halo)
        level = lvl[ys, xs]
        for t in range(len(S._TAPS)):
            got = win[center + tab.win_offs[level, t]]
            o = tab.offs[level, t].to(torch.int64)
            want = d_lin[torch.clamp(ys + o[..., 1], 0, h - 1),
                         torch.clamp(xs + o[..., 0], 0, w - 1)]
            assert torch.equal(got, want), (w, y0, x0, t)
