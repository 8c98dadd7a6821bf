"""Dynamic transforms on port frames (CPU): mutating an entity's Transform
between frames moves the rendered geometry, and moving it back gives the
frame back bit for bit; a light move invalidates the memoized shadow; a
light moved or changed with no spawn shades the next frame as a fresh
prepare's; a spawn and its despawn give the first frame back.  Mirrors
tests/test_dynamic_transforms.py:14, :43 and :78 (the table-level twin of
``refresh_transforms`` is tests/test_torch_scene_ibl.py:101).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mo_renderer_tpu_torch import Renderer, scenes  # noqa: E402
from mo_renderer_tpu_torch.assets.procedural import procedural_model  # noqa: E402
from mo_renderer_tpu_torch.math.transform import Transform  # noqa: E402
from mo_renderer_tpu_torch.scene.components import DirectionalLight  # noqa: E402
from mo_renderer_tpu_torch.scene.world import World  # noqa: E402


# 128x32 frames (the reference's first two tests use 256x128): a CPU
# frame costs ~8x less
SMALL = scenes.tiny_config(width=128, height=32)


@pytest.fixture(scope="module")
def ibl():
    """One computed IBL for every world of the module."""
    res = scenes.tiny_ibl("cpu")
    res.ensure_computed()
    return res


def _sun():
    return DirectionalLight(
        Transform.from_xyz(5.0, 8.0, 5.0).looking_at((0.0, 0.0, 0.0)),
        (1.0, 1.0, 1.0), 4.0, True,
    )


def _renderer(world, ibl, cfg):
    world.insert_resource(ibl)
    world.insert_resource(scenes.camera(cfg))
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    return r


def test_transform_mutation_moves_geometry(ibl):
    world = World()
    t = Transform.from_xyz(0.0, 0.5, 0.0)
    world.spawn((t, procedural_model("cube", base_color=(1, 0, 0, 1))))
    world.spawn((_sun(),))
    r = _renderer(world, ibl, SMALL)
    f0 = r.render(world)
    scene0 = r.scene
    np.testing.assert_array_equal(f0, r.render(world))  # nothing moved
    assert r.scene is scene0

    t.translation = np.array([1.5, 0.5, 0.0], np.float32)
    f1 = r.render(world)
    assert not np.array_equal(f0, f1)

    t.translation = np.array([0.0, 0.5, 0.0], np.float32)
    np.testing.assert_array_equal(r.render(world), f0)
    assert r._prepare_count == 1


def test_shadow_cache_invalidates_on_light_move(ibl):
    """shadow_cache (on by default) recomputes the memoized shadow when the
    caster light moves; the light moved back gives the exact frame back."""
    cfg = SMALL
    assert cfg.shadow_cache
    world = World()
    world.spawn((Transform.from_xyz(0.0, 0.5, 0.0),
                 procedural_model("cube")))
    world.spawn((Transform.from_xyz(0.0, -0.5, 0.0),
                 procedural_model("plane", size=8.0)))
    light = _sun()
    world.spawn((light,))
    r = _renderer(world, ibl, cfg)
    f0 = r.render(world)

    orig = light.transform
    light.transform = Transform.from_xyz(-5.0, 8.0, 5.0).looking_at(
        (0.0, 0.0, 0.0))
    f1 = r.render(world)
    assert not np.array_equal(f0, f1), "stale shadow map served"

    light.transform = orig
    np.testing.assert_array_equal(r.render(world), f0)


# a light's move or edit between frames, each: the sun turned to another
# place, a point light's translation written in place, its colour and
# intensity changed
LIGHT_EDITS = {
    "sun_moved": lambda sun, point: setattr(
        sun, "transform", Transform.from_xyz(-6.0, 4.0, 2.0).looking_at(
            (0.0, 0.0, 0.0))),
    "point_written_in_place": lambda sun, point: point.transform.translation
    .__setitem__(slice(None), np.float32([-1.0, 1.2, 0.5])),
    "point_recoloured": lambda sun, point: (
        point.color.__setitem__(slice(None), np.float32([0.2, 0.4, 1.0])),
        setattr(point, "intensity", 9.0)),
}


@pytest.mark.parametrize("edit", sorted(LIGHT_EDITS))
def test_a_light_edit_shades_the_next_frame(ibl, edit):
    """A light moved or changed between frames, with no spawn or despawn,
    shades the next frame from where it is and as it is now: the frame
    equals a fresh prepare's of the edited world (``refresh_lights``
    rewrites the rows in place, one ``light_rewrites``), and a frame
    with nothing changed rewrites nothing."""
    from mo_renderer_tpu_torch.scene.components import PointLight
    from mo_renderer_tpu_torch.utils import trace

    world = World()
    world.spawn((Transform.from_xyz(0.0, 0.5, 0.0),
                 procedural_model("cube", base_color=(1, 0, 0, 1))))
    world.spawn((Transform.from_xyz(0.0, -0.5, 0.0),
                 procedural_model("plane", size=8.0)))
    sun, point = _sun(), PointLight(Transform.from_xyz(1.5, 1.0, -1.0),
                                    color=(1.0, 0.6, 0.3), intensity=6.0)
    world.spawn((sun,))
    world.spawn((point,))
    r = _renderer(world, ibl, SMALL)
    f0 = r.render(world)
    lights = r.scene.lights
    before = trace.snapshot()["counters"].get("light_rewrites", 0)
    LIGHT_EDITS[edit](sun, point)
    f1 = r.render(world)
    assert not np.array_equal(f0, f1)
    assert r.scene.lights is lights and r._prepare_count == 1
    np.testing.assert_array_equal(f1, _renderer(world, ibl, SMALL)
                                  .render(world))
    np.testing.assert_array_equal(r.render(world), f1)
    assert trace.snapshot()["counters"]["light_rewrites"] == before + 1


def test_topology_change_is_applied(ibl):
    """A spawn after prepare shows in the next frame (world.generation
    drives it; incremental here), and its despawn gives the first frame
    back."""
    world = World()
    world.spawn((Transform.from_xyz(0.0, -0.5, 0.0),
                 procedural_model("plane", size=8.0)))
    world.spawn((_sun(),))
    r = _renderer(world, ibl, SMALL)
    f0 = r.render(world)

    e = world.spawn((Transform.from_xyz(0.0, 0.5, 0.0),
                     procedural_model("cube", base_color=(1, 0, 0, 1))))
    f1 = r.render(world)
    assert not np.array_equal(f0, f1), "new entity not rendered"

    world.despawn(e)
    np.testing.assert_array_equal(r.render(world), f0)
    assert r._prepare_count == 1
