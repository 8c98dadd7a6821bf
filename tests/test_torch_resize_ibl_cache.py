"""``Renderer.resize`` and the IBL disk cache of the port
(mo_renderer_tpu_torch/passes/frame_graph.py, assets/ibl_resource.py).

- A resized Renderer keeps its packed scene, IBL maps and memoized shadow
  table and renders, bit for bit, what a Renderer prepared at the new size
  renders; against the JAX Renderer resized the same way it holds the
  golden bar of tests/test_golden.py:99-107 (mean |diff| < 2/255, fewer
  than 0.5% of channels above 16/255).
- The IBL cache: a save and a load give the same maps bit for bit, a
  truncated file is recomputed, ``from_equirect`` writes nothing unless
  asked, and the maps pass the three checks of
  scripts/eval_configs.py:93-103 on a synthetic sky.

jax is imported inside the one test that needs it.
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mo_renderer_tpu_torch import Renderer, scenes  # noqa: E402
from mo_renderer_tpu_torch.assets.ibl_resource import IBLResource  # noqa: E402
from mo_renderer_tpu_torch.scene.camera import Camera  # noqa: E402

NEW_WH = (320, 160)


def _world(cfg):
    world = scenes.tiny_world()
    world.insert_resource(scenes.camera(cfg))
    return world


def _resized_port_frame():
    """(frame of a Renderer prepared at 256x128 then resized to NEW_WH,
    the renderer, the shadow table it held before the resize)."""
    cfg = scenes.tiny_config()
    world = _world(cfg)
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    r.render(world)
    scene, ibl, quads = r.scene, r.ibl, r._shadow_quads
    assert quads is not None
    r.resize(*NEW_WH)
    world.resource(Camera).resize(NEW_WH)
    frame = r.render(world)
    assert r.ibl is ibl and r._shadow_quads is quads
    assert r.scene.tri_attrs is scene.tri_attrs
    return frame, r, quads


def test_resize_matches_a_renderer_prepared_at_the_new_size():
    frame, r, _ = _resized_port_frame()
    assert (r.config.width, r.config.height) == NEW_WH
    assert (r.pad_w, r.pad_h) == (384, 160)
    cfg = scenes.tiny_config(width=NEW_WH[0], height=NEW_WH[1])
    world = _world(cfg)
    fresh = Renderer(cfg, "cpu")
    fresh.prepare(world)
    want = fresh.render(world)
    assert frame.shape == (NEW_WH[1], NEW_WH[0], 4)
    np.testing.assert_array_equal(frame, want)


def test_resize_keeps_the_shadow_table(monkeypatch):
    """No shadow raster runs after a resize: the memo key (light matrix,
    scene object) does not involve the framebuffer size."""
    from mo_renderer_tpu_torch.passes import frame_graph as FG

    cfg = scenes.tiny_config()
    world = _world(cfg)
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    r.render(world)
    quads = r._shadow_quads
    calls = []
    monkeypatch.setattr(FG, "shadow_program",
                        lambda *a, **k: calls.append(1) or (None, 0))
    r.resize(*NEW_WH)
    world.resource(Camera).resize(NEW_WH)
    r.render(world)
    assert calls == [] and r._shadow_quads is quads


def test_resized_frame_matches_the_resized_reference():
    import __graft_entry__ as graft
    from mo_renderer_tpu.passes.frame_graph import Renderer as JRenderer

    frame, _, _ = _resized_port_frame()
    cfg = graft._tiny_config()
    world = graft._tiny_world()
    world.insert_resource(graft._camera(cfg))
    jr = JRenderer(cfg)
    jr.prepare(world)
    jr.resize(*NEW_WH)
    cam = graft._camera(dataclasses.replace(cfg, width=NEW_WH[0],
                                            height=NEW_WH[1]))
    world.insert_resource(cam)
    ref = np.asarray(jr.render(world)).astype(np.int32)
    diff = np.abs(frame.astype(np.int32) - ref)[..., :3]
    print(f"resized {NEW_WH} vs JAX: max |diff| {diff.max()} LSB, mean "
          f"{diff.mean():.4f}, {(diff > 16).mean():.4%} > 16")
    assert frame.shape == ref.shape
    assert diff.mean() < 2.0 and (diff > 16).mean() < 0.005


# --- the IBL disk cache ------------------------------------------------------

IBL_SIZES = dict(cubemap_size=16, irradiance_size=8, specular_mips=3,
                 specular_samples=8, brdf_lut_size=16)


def _ibl(**kw):
    return IBLResource.from_equirect(scenes.synthetic_sky(), device="cpu",
                                     **IBL_SIZES, **kw)


def _map_tensors(m):
    return {
        "environment": m.environment_faces, "irradiance": m.irradiance_faces,
        "specular_mips": m.specular_mips.data, "brdf_lut": m.brdf_lut,
        "specular_quad": m.specular_quad.rows,
        "specular_quad_merged": m.specular_quad_merged.rows,
        "irradiance_sh9": m.irradiance_sh9,
    }


def _assert_maps_equal(got, want):
    for name, t in _map_tensors(want).items():
        g = _map_tensors(got)[name]
        assert g.device == t.device, name
        assert torch.equal(g, t), name
    np.testing.assert_array_equal(got.specular_mips.sizes,
                                  want.specular_mips.sizes)


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("MO_CACHE_DIR", str(tmp_path))
    return tmp_path


def test_ibl_cache_round_trip(cache_dir, caplog):
    first = _ibl(cache=True)
    first.ensure_computed()
    files = sorted(os.listdir(cache_dir))
    assert len(files) == 1 and files[0].startswith("ibl-torch-equirect-")
    with np.load(cache_dir / files[0]) as data:
        assert sorted(data.files) == ["brdf_lut", "environment",
                                      "irradiance", "spec_0", "spec_1",
                                      "spec_2"]
    fresh = _ibl(cache=True)
    with caplog.at_level("INFO", logger="mo_renderer_tpu_torch"):
        fresh.ensure_computed()
    assert "IBL loaded from cache" in caplog.text
    _assert_maps_equal(fresh.maps(), first.maps())


def test_ibl_truncated_cache_recomputes(cache_dir, caplog):
    first = _ibl(cache=True)
    first.ensure_computed()
    (path,) = cache_dir.iterdir()
    path.write_bytes(path.read_bytes()[: path.stat().st_size // 2])
    again = _ibl(cache=True)
    with caplog.at_level("WARNING", logger="mo_renderer_tpu_torch"):
        again.ensure_computed()
    assert "IBL cache load failed" in caplog.text
    _assert_maps_equal(again.maps(), first.maps())
    # the recompute wrote a whole file again
    with np.load(path) as data:
        assert "spec_2" in data.files


def test_ibl_cache_false_and_from_equirect_write_nothing(cache_dir):
    res = IBLResource(cache=False, device="cpu")
    assert res.use_cache is False
    default = _ibl()
    assert default.use_cache is False
    default.ensure_computed()
    _ibl(cache=False).ensure_computed()
    assert list(cache_dir.iterdir()) == []


def test_ibl_passes_the_eval_checks():
    """scripts/eval_configs.py:93-103 on a synthetic sky: specular mip 0
    equals the environment, the irradiance stays inside the environment's
    range, every map is finite."""
    m = _ibl().maps()
    env = m.environment_faces.numpy()
    irr = m.irradiance_faces.numpy()
    mip0 = m.specular_mips.level(0).numpy()
    assert np.allclose(mip0[..., :3], env[..., :3], rtol=1e-3, atol=1e-3)
    assert irr[..., :3].max() <= env[..., :3].max() * 1.05 + 1e-3
    assert np.isfinite(env).all() and np.isfinite(irr).all()
