"""Incremental topology in the port (``scene_buffers.incremental_repack``
behind ``Renderer._sync_topology``): a spawn or despawn within the packed
capacities rewrites rows of the padded tables in place, and anything the
static layout cannot absorb falls back to a full ``prepare``.

Mirrors tests/test_incremental_prepare.py on port frames (CPU, 128x32),
with ``_prepare_count`` and ``scene._host_pack`` where the reference reads
``_frame_fn``.  Bars: every incremental frame equals, bit for bit, the
frame of a fresh ``prepare`` of the same world.  The JAX Renderer after
the same spawn and despawn: tests/test_torch_topology_jax.py.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mo_renderer_tpu_torch import Renderer, scenes  # noqa: E402
from mo_renderer_tpu_torch.assets.procedural import procedural_model  # noqa: E402
from mo_renderer_tpu_torch.math.transform import Transform  # noqa: E402
from mo_renderer_tpu_torch.scene.components import DirectionalLight  # noqa: E402
from mo_renderer_tpu_torch.scene.world import World  # noqa: E402


@pytest.fixture(scope="module")
def ibl():
    """One computed IBL for every world of the module (the precompute is
    most of a prepare's time on the CPU)."""
    res = scenes.tiny_ibl("cpu")
    res.ensure_computed()
    return res


def _base_world(ibl):
    """tests/test_incremental_prepare.py:22-31 with the port's classes."""
    world = World()
    world.spawn((Transform.from_xyz(0.0, -0.5, 0.0),
                 procedural_model("plane", size=8.0)))
    world.spawn((DirectionalLight(
        Transform.from_xyz(5.0, 8.0, 5.0).looking_at((0.0, 0.0, 0.0)),
        (1.0, 1.0, 1.0), 4.0, True,
    ),))
    world.insert_resource(ibl)
    return world


def _renderer(world, **kw):
    cfg = scenes.tiny_config(width=128, height=32, **kw)
    world.insert_resource(scenes.camera(cfg))
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    return r


def _fresh_frame(r, world):
    """The oracle: a from-scratch prepare of the same world."""
    r2 = Renderer(r.config, "cpu")
    r2.prepare(world)
    return r2.render(world)


def _cube(x=0.0, y=0.5, color=(1, 0, 0, 1)):
    return (Transform.from_xyz(x, y, 0.0),
            procedural_model("cube", base_color=color))


def test_spawn_and_despawn_are_incremental(ibl):
    world = _base_world(ibl)
    r = _renderer(world)
    f0 = r.render(world)
    pack_before = r.scene._host_pack

    # spawn: a default-texture cube reuses the packed default layers
    e = world.spawn(_cube())
    f1 = r.render(world)
    assert not np.array_equal(f0, f1), "spawned entity not rendered"
    assert r._prepare_count == 1, "incremental spawn ran a full prepare"
    assert r.scene._host_pack is pack_before

    # despawn: the tri_valid mask gives the pre-spawn frame back
    world.despawn(e)
    np.testing.assert_array_equal(r.render(world), f0)
    assert r._prepare_count == 1, "incremental despawn ran a full prepare"
    assert r.scene._host_pack is pack_before


def test_incremental_spawn_matches_full_prepare(ibl):
    world = _base_world(ibl)
    r = _renderer(world)
    r.render(world)
    world.spawn(_cube(0.6, 0.3, (0.2, 0.9, 0.2, 1)))
    f_inc = r.render(world)
    assert r._prepare_count == 1
    np.testing.assert_array_equal(f_inc, _fresh_frame(r, world))


def test_new_texture_content_falls_back_to_full_prepare(ibl):
    world = _base_world(ibl)
    r = _renderer(world)
    r.render(world)
    pack_before = r.scene._host_pack
    # a textured model brings new image content: the stacks must grow
    world.spawn((Transform.from_xyz(0.0, 0.5, 0.0),
                 procedural_model("cube", textured=True)))
    f1 = r.render(world)
    assert f1[..., :3].max() > 0
    assert r._prepare_count == 2, "expected exactly one full re-prepare"
    assert r.scene._host_pack is not pack_before


def test_light_count_change_falls_back(ibl):
    world = _base_world(ibl)
    r = _renderer(world)
    r.render(world)
    world.spawn((DirectionalLight(
        Transform.from_xyz(-5.0, 8.0, -5.0).looking_at((0.0, 0.0, 0.0)),
        (1.0, 0.5, 0.5), 2.0, False,
    ),))
    r.render(world)
    # the shading loop is specialised to the live light count
    assert r._prepare_count == 2
    assert r._n_lights == 2


def test_move_then_spawn_keeps_moved_transform(ibl):
    """refresh_transforms must keep the pack state's mirrors in sync: a
    spawn after a move writes mesh rows from the mirror, which would
    silently revert the move if stale."""
    world = _base_world(ibl)
    t = Transform.from_xyz(0.0, 0.5, 0.0)
    world.spawn((t, procedural_model("cube", base_color=(1, 0, 0, 1))))
    r = _renderer(world)
    r.render(world)

    t.translation = np.array([1.0, 0.5, 0.0], np.float32)
    moved = r.render(world)
    world.spawn(_cube(-1.0, 0.5, (0, 0, 1, 1)))
    after_spawn = r.render(world)
    assert r._prepare_count == 1
    np.testing.assert_array_equal(after_spawn, _fresh_frame(r, world))
    assert not np.array_equal(moved, after_spawn)  # new cube visible


def test_same_frame_move_and_spawn(ibl):
    """A transform moved in the same frame as a spawn (no render between)
    must still be baked: incremental_repack carries the old TRS cache."""
    world = _base_world(ibl)
    t = Transform.from_xyz(0.0, 0.5, 0.0)
    world.spawn((t, procedural_model("cube", base_color=(1, 0, 0, 1))))
    r = _renderer(world)
    r.render(world)
    t.translation = np.array([1.0, 0.5, 0.0], np.float32)
    world.spawn(_cube(-1.0, 0.5, (0, 0, 1, 1)))
    frame = r.render(world)
    assert r._prepare_count == 1
    np.testing.assert_array_equal(frame, _fresh_frame(r, world))


def test_large_despawn(ibl):
    """A despawn of more than 4096 triangles (the reference chains 1024-row
    upload chunks here; the port writes the range of tri_valid once): the
    masked frame equals a fresh pack of the world without the entity, and
    only tri_valid changes."""
    world = _base_world(ibl)
    big = procedural_model("sphere", base_color=(0.2, 0.9, 0.3, 1.0),
                           rings=40, sectors=52)
    assert len(big.meshes[0].primitive.indices) // 3 > 4 * 1024
    e = world.spawn((Transform.from_xyz(0.0, 0.6, 0.0), big))
    r = _renderer(world)
    f_with = r.render(world)
    before = {k: v.clone() for k, v in vars(r.scene).items()
              if torch.is_tensor(v)}

    world.despawn(e)
    f_masked = r.render(world)
    assert r._prepare_count == 1, "despawn must stay incremental"
    changed = [k for k, v in before.items()
               if not torch.equal(v, getattr(r.scene, k))]
    assert changed == ["tri_valid"], changed
    assert not np.array_equal(f_with, f_masked), "sphere still visible"
    np.testing.assert_array_equal(f_masked, _fresh_frame(r, world))
    r.check_overflow()


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "reference"])
def test_uv1_spawn(fast, ibl):
    """The forbid_uv1 guard: on the fast path (UV set 0 only) a spawned
    UV1 material falls back to a prepare, which takes the reference
    sampling path; with fast_sampling=False the spawn stays incremental."""
    world = _base_world(ibl)
    r = _renderer(world, fast_sampling=fast)
    cube = procedural_model("cube", base_color=(1, 0, 0, 1))
    scenes.use_uv1(cube)
    world.spawn((Transform.from_xyz(0.0, 0.5, 0.0), cube))
    frame = r.render(world)
    assert r._prepare_count == (2 if fast else 1)
    assert r._fast is False
    np.testing.assert_array_equal(frame, _fresh_frame(r, world))


def test_spawned_caster_changes_the_shadow(ibl):
    """The memoized shadow keys on the scene object: a spawn hands the
    Renderer a new SceneBuffers, so the table is recomputed and the new
    cube casts its shadow."""
    world = _base_world(ibl)
    r = _renderer(world)
    r.render(world)
    quads_before = r._shadow_quads
    world.spawn(_cube(0.0, 0.5))
    f1 = r.render(world)
    assert r._prepare_count == 1
    assert r._shadow_scene is r.scene
    assert not torch.equal(r._shadow_quads, quads_before)
    np.testing.assert_array_equal(f1, _fresh_frame(r, world))


def test_light_colour_change_repacks_lights_in_place(ibl):
    """Same light count, new content, picked up with the next topology
    change: the light rows are rewritten in place (the same tensor), no
    prepare runs."""
    world = _base_world(ibl)
    r = _renderer(world)
    r.render(world)
    lights_before = r.scene.lights
    row_before = lights_before[0].clone()
    light = next(iter(world.query(DirectionalLight)))
    light.color = np.array([1.0, 0.3, 0.2], np.float32)
    world.spawn(_cube(0.0, 0.5))
    frame = r.render(world)
    assert r._prepare_count == 1
    assert r.scene.lights is lights_before
    assert not torch.equal(r.scene.lights[0], row_before)
    np.testing.assert_array_equal(frame, _fresh_frame(r, world))


def test_grid_world_spawn_host_cost(ibl):
    """The port's twin of tests/test_incremental_prepare.py:224 on the
    asset-free stress scene (grid_world(7), 50 entities, 25K triangles): a
    spawn at that scale is incremental; the wall-clock bound is asserted
    only under MO_PERF_ASSERTS, as in the reference.  The shadow map is
    off: its plain raster of the whole grid takes ~10 s on the CPU, and
    the shadow memo is held by test_spawned_caster_changes_the_shadow."""
    cfg = scenes.tiny_config(shadow_enabled=False)
    world = scenes.grid_world(7)
    world.insert_resource(ibl)  # the same synthetic sky, computed once
    world.insert_resource(scenes.grid_camera(cfg))
    r = Renderer(cfg, "cpu")
    r.prepare(world)

    world.spawn((Transform.from_xyz(0.0, 2.0, 0.0),
                 procedural_model("cube", base_color=(1, 1, 0, 1))))
    t0 = time.perf_counter()
    r._sync_topology(world)
    dt = time.perf_counter() - t0
    assert r._prepare_count == 1, "grid-scale spawn must be incremental"
    if os.environ.get("MO_PERF_ASSERTS"):
        assert dt < 0.5, f"incremental repack took {dt:.3f}s"
    f = r.render(world)
    assert f[..., :3].max() > 0
    r.check_overflow()
