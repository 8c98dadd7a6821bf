"""Camera-path sequences and the RenderPass API in the port, against the
port's own per-frame dispatch and the JAX package.

- A probe ``RenderPass`` sees the frame context at the padded full
  resolution (the checkerboard is switched off under extra passes) and
  dims the frame; the port's probed frame holds the golden bar of
  tests/test_golden.py:99-107 (mean |diff| < 2/255, fewer than 0.5% of
  channels above 16/255) against the JAX ``Renderer(extra_passes=[...])``
  frame with the same pass (the reference's bar:
  tests/test_config_wiring.py:241-278).  ``resize`` reaches
  ``on_swapchain_recreate``.
- ``render_sequence_device`` equals ``render_device`` at every pose bit
  for bit, with the light fixed (the memoized shadow) and with it moving
  (a shadow per step): the reference's bar, tests/test_sequence_render.py
  (its scan equals its per-frame dispatch bit for bit).  Frame 0 of the
  probed sequence holds the golden bar against the JAX frame at that
  pose.  On the CPU the sequence is a loop over the frame; the CUDA
  graph replay is checked on the card (``chip_smoke.py`` phase 3).
- Binning under the static capacity (what the graph captures and the
  eager frame runs) lists the exact pairs, each (tile, triangle) pair of
  the boxes listed one by one, pair for pair while the total fits the
  capacity; past it, the first triangles' pairs, and the rest counted.
- ``Renderer._binned_cap`` is the reference's formula
  (frame_graph.py:481-511) over the port's own 32x128 bins: equal to the
  JAX Renderer's at the default 1080p tiling, whose bins are 32x128 too,
  and smaller by the xlarge term on the tiny config's 16-row bins.

One JAX frame is compiled in this file.
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402,F401
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mo_renderer_tpu.kernels import raster_setup as JRS  # noqa: E402
from mo_renderer_tpu.passes.frame_graph import Renderer as JRenderer  # noqa: E402
from mo_renderer_tpu.passes.frame_graph import RenderPass as JRenderPass  # noqa: E402
from mo_renderer_tpu_torch import Renderer, RenderPass, scenes  # noqa: E402
from mo_renderer_tpu_torch.kernels import raster_setup as RS  # noqa: E402
from mo_renderer_tpu_torch.kernels.rasterizer import BIN_H, BIN_W  # noqa: E402
from mo_renderer_tpu_torch.passes.frame_graph import (  # noqa: E402
    _bin,
    build_camera_params,
)
from mo_renderer_tpu_torch.scene.camera import Camera  # noqa: E402
from mo_renderer_tpu_torch.scene.components import DirectionalLight  # noqa: E402
from mo_renderer_tpu_torch.scene.scene_buffers import find_shadow_light  # noqa: E402
from test_torch_binning_contract import listed_pairs, runs  # noqa: E402


def _golden_bar(frame, ref, what):
    diff = np.abs(frame.astype(np.int32) - ref.astype(np.int32))[..., :3]
    print(f"{what}: max |diff| {diff.max()} LSB, mean {diff.mean():.4f}")
    assert diff.mean() < 2.0 and (diff > 16).mean() < 0.005


def _probe(base):
    """A pass that records the context's shapes and halves the colour,
    on the port's or the reference's RenderPass."""
    class Probe(base):
        def __init__(self):
            self.seen, self.sizes = [], []

        def render(self, ctx):
            self.seen.append((tuple(ctx["color"].shape[:2]),
                              tuple(ctx["ssao"].shape[:2]),
                              tuple(ctx["gbuffer"].depth.shape[:2])))
            return dict(ctx, color=ctx["color"] * 0.5)

        def on_swapchain_recreate(self, window_size):
            self.sizes.append(window_size)

    return Probe()


@pytest.fixture(scope="module")
def port():
    """The tiny scene on the CPU: a plain Renderer and one with a probe."""
    cfg = scenes.tiny_config()
    world = scenes.tiny_world()
    world.insert_resource(scenes.camera(cfg))
    plain = Renderer(cfg, "cpu")
    plain.prepare(world)
    probe = _probe(RenderPass)
    probed = Renderer(cfg, "cpu", extra_passes=[probe])
    probed.prepare(world)
    return dict(cfg=cfg, world=world, plain=plain, probed=probed,
                probe=probe)


@pytest.fixture(scope="module")
def jax_probed():
    """The JAX Renderer with the same probe at the camera's first pose
    (the one JAX frame of this file)."""
    cfg = graft._tiny_config()
    world = graft._tiny_world()
    world.insert_resource(graft._camera(cfg))
    probe = _probe(JRenderPass)
    r = JRenderer(cfg, extra_passes=[probe])
    r.prepare(world)
    return r, r.render(world), probe, world


def _poses(world, n=3):
    """Step the camera along +x, ``n`` poses (render, then restore)."""
    camera = world.resource(Camera)
    base = np.asarray(camera.transform.translation, np.float64).copy()
    for i in range(n):
        camera.transform.translation = (
            base + np.array([0.1 * i, 0.0, 0.0])).astype(np.float32)
        camera.refresh_view()
        yield i
    camera.transform.translation = base.astype(np.float32)
    camera.refresh_view()


def test_probe_pass_sees_full_resolution_and_matches_reference(
        port, jax_probed):
    r, probe = port["probed"], port["probe"]
    frame = r.render(port["world"])
    pad_hw = (r.pad_h, r.pad_w)
    assert probe.seen[-1] == (pad_hw, pad_hw, pad_hw)
    full = port["plain"].render(port["world"])
    assert frame[..., :3].astype(int).sum() < \
        0.6 * full[..., :3].astype(int).sum()
    jr, jframe, jprobe, _ = jax_probed
    assert jprobe.seen[-1] == (pad_hw,) * 3
    _golden_bar(frame, jframe, "probed frame vs JAX probed frame")


def test_resize_calls_on_swapchain_recreate():
    probe = _probe(RenderPass)
    r = Renderer(scenes.tiny_config(), "cpu", extra_passes=[probe])
    r.resize(128, 64)
    assert probe.sizes == [(128, 64)]
    assert (r.pad_w, r.pad_h) == (128, 64)


@pytest.mark.parametrize("which", ["plain", "probed"])
def test_sequence_equals_per_frame_dispatch(port, jax_probed, which):
    """Fixed light: the memoized shadow; frames differ along the path."""
    r, world = port[which], port["world"]
    light_pv, _ = find_shadow_light(world)
    params, singles = [], []
    for _ in _poses(world):
        params.append(build_camera_params(world.resource(Camera), light_pv,
                                          "cpu"))
        singles.append(r.render_device(world).clone())
    frames = r.render_sequence_device(world, params)
    assert frames.shape == (3,) + singles[0].shape
    for i in range(3):
        assert torch.equal(frames[i], singles[i]), i
    assert not torch.equal(frames[0], frames[1])
    r.check_overflow()
    if which == "probed":
        from mo_renderer_tpu_torch.passes.present import unpack_rgba8

        _golden_bar(unpack_rgba8(frames[0]), jax_probed[1],
                    "sequence frame 0 vs JAX frame")


def test_sequence_with_a_moving_light_equals_per_frame_dispatch(port):
    """Each step's light matrix differs from the world's: every step
    rasterizes its own shadow map and still equals render_device with
    the world's light moved to that step's."""
    r, world = port["plain"], port["world"]
    light = next(lt for lt in world.query(DirectionalLight)
                 if lt.is_shadow_caster)
    width = light.shadow_width
    params, singles = [], []
    try:
        for i in _poses(world):
            light.shadow_width = width + 0.5 * i
            light_pv, _ = find_shadow_light(world)
            params.append(build_camera_params(world.resource(Camera),
                                              light_pv, "cpu"))
            singles.append(r.render_device(world).clone())
    finally:
        light.shadow_width = width
    quads_before = r._shadow_quads
    frames = r.render_sequence_device(world, params)
    assert r._shadow_quads is quads_before  # no memo for moving lights
    for i in range(3):
        assert torch.equal(frames[i], singles[i]), i
    r.check_overflow()


def _setups(port):
    """Triangle setups of the tiny scene: the frame at three poses and
    the shadow map."""
    r, world = port["plain"], port["world"]
    out = []
    for _ in _poses(world):
        params, _ = r.frame_params(world)
        out.append((RS.triangle_setup_from_attrs(
            r.scene.tri_attrs, r.scene.tri_valid, params["proj_view"],
            r.pad_w, r.pad_h), r.pad_w, r.pad_h))
    s = port["cfg"].shadow_map_size
    out.append((RS.triangle_setup_from_attrs(
        r.scene.tri_attrs, r.scene.tri_valid, params["light_proj_view"], s,
        s, cull_backface=False), s, s))
    return out


def _exact_pairs(setup, w):
    """The setup's (tile, triangle) pairs in the frame's bins, listed one
    by one in slot order (draw order)."""
    return listed_pairs(setup, tile_h=BIN_H, tile_w=BIN_W,
                        n_tiles_x=-(-w // BIN_W))


def test_static_binning_equals_exact_binning(port):
    cap = port["plain"]._binned_cap
    for setup, w, h in _setups(port):
        pairs = _exact_pairs(setup, w)
        static = _bin(setup, w, h, cap)
        assert 0 < len(pairs) <= cap and static.pair_tri.shape == (cap,)
        assert torch.is_tensor(static.overflow) and static.overflow == 0
        assert runs(static) == sorted(pairs)
        assert torch.equal(static.bbox, setup.bbox)  # no huge triangle


def test_static_binning_overflow_equals_exact_binning(port):
    for setup, w, h in _setups(port):
        pairs = _exact_pairs(setup, w)
        total = len(pairs)
        for cap in (8, total // 2, total - 1):
            static = _bin(setup, w, h, cap)
            assert torch.is_tensor(static.overflow)
            assert int(static.overflow) == total - cap
            assert runs(static) == sorted(pairs[:cap])


def test_binned_cap_is_the_reference_formula(port, jax_probed):
    """The reference counts its bins as tile_h / raster_sub_y x tile_w
    (16 x 128 on the tiny config: 32 in the 256^2 shadow map); the port
    bins at 32 x 128 (16): the formula agrees term for term, and the
    capacities differ by the xlarge class's 8 pairs x 16 tiles.  At the
    default 1080p tiling both bin at 32 x 128 and agree exactly."""
    jr, jworld = jax_probed[0], jax_probed[3]
    cfg = port["cfg"]
    r = port["plain"]
    t = int(r.scene.indices.shape[0])
    assert t == int(jr.scene.indices.shape[0])
    s = cfg.shadow_map_size
    bin_h = cfg.tile_h // cfg.raster_sub_y
    jax_tiles = max((jr.pad_w // cfg.tile_w) * (jr.pad_h // bin_h),
                    (s // cfg.tile_w) * (s // bin_h))
    assert RS.pair_capacity(t, jax_tiles) == jr._binned_cap
    for name in ("default_medium_cap", "default_large_cap",
                 "default_xlarge_cap"):
        assert getattr(RS, name)(t) == getattr(JRS, name)(t)
    assert RS.LARGE_SPAN == JRS.LARGE_SPAN
    port_tiles = max(-(-r.pad_w // BIN_W) * -(-r.pad_h // BIN_H),
                     -(-s // BIN_W) * -(-s // BIN_H))
    assert r._binned_cap == RS.pair_capacity(t, port_tiles)
    assert r._binned_cap == jr._binned_cap - (
        (jax_tiles - port_tiles) * RS.default_xlarge_cap(t))
    # at the default 1080p tiling (64-row tiles, raster_sub_y 2) the
    # reference bins at 32 x 128 too: the capacities are equal
    j1080 = JRenderer(dataclasses.replace(cfg, width=1920, height=1080,
                                          tile_h=None, raster_sub_y=None))
    j1080.prepare(jworld)
    r1080 = Renderer(dataclasses.replace(cfg, width=1920, height=1080,
                                         tile_h=None, raster_sub_y=None),
                     "cpu")
    r1080.prepare(port["world"])
    assert r1080.config.tile_h // r1080.config.raster_sub_y == BIN_H
    assert r1080._binned_cap == j1080._binned_cap
    # a configured capacity is rounded up to 8, as in the reference
    r2 = Renderer(dataclasses.replace(cfg, binned_cap=10001), "cpu")
    r2.prepare(port["world"])
    assert r2._binned_cap == 10008
