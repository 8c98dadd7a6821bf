"""The host side of a replayed frame (``Renderer.render_device``): each
step checks what it saw last and rebuilds only what changed
(mo_renderer_tpu_torch/passes/frame_graph.py, scene/scene_buffers.py).

- the camera block (``_write_camera_block``: the basis in float32
  scalars) is byte for byte the numpy construction kept here as the
  plain version, over seeded poses, through ``build_camera_params`` and
  ``Renderer.frame_params``, with and without a shadow light;
- ``find_shadow_light`` finds the light the full scan finds after a
  spawn, a despawn, an ``Entity.insert`` and an ``is_shadow_caster``
  toggle, and the light's matrix memo sees an element written in place;
- ``refresh_transforms`` re-bakes after an element written in place or
  an array replaced, and does nothing otherwise;
- the captured frame's key is built again after a resize, a prepare, a
  light appearing or going, an extra pass and a tracer switch, and kept
  across camera moves, entity moves, spawns and despawns;
- the counters ``camera_block_builds``, ``transform_bakes`` and
  ``graph_key_builds`` over a walk and a spawn.

CPU, no JAX: the tiny scene at 128x32, the frames' host side only.
"""

import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mo_renderer_tpu_torch import Renderer, RenderPass, scenes  # noqa: E402
from mo_renderer_tpu_torch.assets.model import Model  # noqa: E402
from mo_renderer_tpu_torch.assets.procedural import procedural_model  # noqa: E402
from mo_renderer_tpu_torch.math import quat  # noqa: E402
from mo_renderer_tpu_torch.math.transform import Transform  # noqa: E402
from mo_renderer_tpu_torch.passes.frame_graph import build_camera_params  # noqa: E402
from mo_renderer_tpu_torch.scene.camera import Camera, CameraSettings  # noqa: E402
from mo_renderer_tpu_torch.scene.components import DirectionalLight  # noqa: E402
from mo_renderer_tpu_torch.scene.scene_buffers import (  # noqa: E402
    find_shadow_light,
    pack_scene,
    refresh_transforms,
)
from mo_renderer_tpu_torch.scene.world import World  # noqa: E402
from mo_renderer_tpu_torch.utils import trace  # noqa: E402


def _plain_block(camera, light_pv):
    """The camera block as numpy built it before the scalar basis."""
    proj = camera.projection()
    near = camera.near_p()
    near_h = 2.0 * near * np.tan(camera.fov() / 2.0)
    near_w = camera.aspect() * near_h
    buf = np.zeros(64, np.float32)
    buf[0:16] = np.asarray(proj @ camera.view(), np.float32).reshape(-1)
    buf[16:32] = np.asarray(proj @ camera.prev_view(), np.float32).reshape(-1)
    buf[32:48] = np.asarray(light_pv, np.float32).reshape(-1)
    buf[48:51] = camera.position()
    buf[51:54] = camera.direction()
    buf[54:57] = camera.right()
    buf[57:60] = camera.up()
    buf[60] = near
    buf[61:63] = (near_w, near_h)
    return buf


def _plain_light(world):
    """The shadow light as the full scan finds it."""
    for light in world.query(DirectionalLight):
        if light.is_shadow_caster:
            return light.proj_view(), True
    return np.eye(4, dtype=np.float32), False


def _yaw_pitch(yaw, pitch):
    return quat.mul(quat.from_rotation_y(yaw), quat.from_rotation_x(pitch))


# a pose generator a kind: (rng, i) -> (position, rotation)
POSES = {
    "identity": lambda rng, i: ((0.0, 0.0, 0.0) if i == 0
                                else rng.normal(0, 5, 3), quat.IDENTITY),
    "pitch_up": lambda rng, i: (rng.normal(0, 5, 3), _yaw_pitch(
        rng.uniform(-np.pi, np.pi), np.pi / 2)),
    "pitch_down": lambda rng, i: (rng.normal(0, 5, 3), _yaw_pitch(
        rng.uniform(-np.pi, np.pi), -np.pi / 2)),
    "yaw_wrap": lambda rng, i: (rng.normal(0, 5, 3), _yaw_pitch(
        np.pi * (1 + rng.uniform(-1e-3, 1e-3)) * rng.choice([-1, 1, 3]),
        rng.uniform(-1.5, 1.5))),
    "random": lambda rng, i: (rng.normal(0, 50, 3), quat.normalize(
        rng.normal(0, 1, 4))),
}
SIZES = [(1920, 1080), (1080, 1920), (1, 1), (333, 777), (128, 32)]


def _camera(rng, kind, i):
    cam = Camera()
    if i % 7 == 3:
        cam.settings = CameraSettings.new_orthographic()
    cam.resize(SIZES[i % len(SIZES)])
    for _ in range(2):  # a previous view that differs from the view
        pos, rot = POSES[kind](rng, i)
        cam.transform.translation = np.asarray(pos, np.float32)
        cam.transform.rotation = np.asarray(rot, np.float32)
        cam.refresh_view()
    return cam


def _sun(rng):
    pos = rng.normal(0, 10, 3)
    return DirectionalLight(
        Transform.from_translation(pos).looking_at((0.0, 0.0, 0.0)),
        is_shadow_caster=True, shadow_width=float(rng.uniform(4, 40)),
        shadow_height=float(rng.uniform(4, 40)))


@pytest.mark.parametrize("light", [True, False], ids=["sun", "no_light"])
@pytest.mark.parametrize("kind", list(POSES))
def test_camera_block_is_the_numpy_construction(kind, light):
    """60 seeded poses of a kind: the block's bytes through
    ``build_camera_params`` and through ``Renderer.frame_params`` (the
    replayed frame's block) equal the numpy construction's."""
    rng = np.random.default_rng([25, list(POSES).index(kind), light])
    r = Renderer(scenes.tiny_config(), "cpu")
    for i in range(60):
        world = World()
        if light:
            world.spawn((_sun(rng),))
        cam = _camera(rng, kind, i)
        world.insert_resource(cam)
        light_pv, has_light = find_shadow_light(world)
        assert has_light == light
        want = _plain_block(cam, light_pv).tobytes()
        assert build_camera_params(cam, light_pv, "cpu").host.tobytes() \
            == want
        params, got_light = r.frame_params(world)
        assert got_light == light
        assert params.host.tobytes() == want
        assert params.vec.numpy().tobytes() == want


def test_frame_params_builds_only_on_a_change():
    """The same inputs give the same block object; a moved camera, a
    refreshed view and a moved light each build a block again, counted
    by ``camera_block_builds``."""
    rng = np.random.default_rng(2525)
    world = World()
    sun = _sun(rng)
    world.spawn((sun,))
    cam = _camera(rng, "random", 0)
    world.insert_resource(cam)
    r = Renderer(scenes.tiny_config(), "cpu")
    trace.reset()
    first, _ = r.frame_params(world)
    assert r.frame_params(world)[0] is first
    edits = [
        lambda: cam.transform.translation.__setitem__(0, 1.5),
        cam.refresh_view,  # the previous view now equals the view
        lambda: sun.transform.translation.__setitem__(1, 7.25),
        lambda: cam.resize((64, 64)),
    ]
    prev = first
    for edit in edits:
        edit()
        got, _ = r.frame_params(world)
        assert got is not prev
        assert got.host.tobytes() == _plain_block(
            cam, find_shadow_light(world)[0]).tobytes()
        prev = got
    assert trace.snapshot()["counters"]["camera_block_builds"] == 5
    trace.reset()


def _light_world(edit):
    """A world of a model, a shadow caster and a light that casts none,
    then ``edit`` applied: (world, the lights)."""
    world = World()
    world.spawn((Transform.from_xyz(0.0, 0.0, 0.0),
                 procedural_model("cube")))
    a = DirectionalLight(Transform.from_xyz(5.0, 8.0, 5.0).looking_at(
        (0.0, 0.0, 0.0)), is_shadow_caster=False)
    b = DirectionalLight(Transform.from_xyz(-5.0, 8.0, 5.0).looking_at(
        (0.0, 0.0, 0.0)), is_shadow_caster=True)
    ea = world.spawn((a,))
    eb = world.spawn((b,))
    model = world.spawn((Transform.from_xyz(1.0, 0.0, 0.0),
                         procedural_model("sphere")))
    c = DirectionalLight(Transform.from_xyz(0.0, 9.0, -5.0).looking_at(
        (0.0, 0.0, 0.0)), is_shadow_caster=True)
    {
        "none": lambda: None,
        "spawn": lambda: world.spawn((c,)),
        "despawn": lambda: world.despawn(eb),
        "despawn_then_spawn": lambda: (world.despawn(eb),
                                       world.spawn((c,))),
        "insert": lambda: model.insert(c),
        "insert_first": lambda: world.entity_components(0).update(
            {DirectionalLight: c}),
        "toggle_on": lambda: setattr(a, "is_shadow_caster", True),
        "toggle_off": lambda: setattr(b, "is_shadow_caster", False),
        "all_off": lambda: (setattr(b, "is_shadow_caster", False),
                            world.despawn(ea)),
    }[edit]()
    return world


@pytest.mark.parametrize("edit", ["none", "spawn", "despawn",
                                  "despawn_then_spawn", "insert",
                                  "insert_first", "toggle_on", "toggle_off",
                                  "all_off"])
def test_shadow_light_lookup_is_the_scan(edit):
    """``find_shadow_light`` returns the light the full scan returns (the
    same memoized matrix object, so the same light) after each edit."""
    world = _light_world(edit)
    got, found = find_shadow_light(world)
    want, want_found = _plain_light(world)
    assert found == want_found
    if found:
        assert got is want
    else:
        assert got.tobytes() == want.tobytes()


def test_light_matrix_memo_sees_an_element_written_in_place():
    """The memo of ``DirectionalLight.proj_view`` keys on the bytes of the
    translation and rotation: an element written in place, or a zero's
    sign, gives the matrix a fresh light computes."""
    light = DirectionalLight(Transform.from_xyz(0.0, 8.0, 5.0).looking_at(
        (0.0, 0.0, 0.0)), is_shadow_caster=True)
    before = light.proj_view()
    assert light.proj_view() is before
    for i, v in ((0, 2.5), (0, -0.0), (2, 7.0)):
        light.transform.translation[i] = v
        fresh = DirectionalLight(Transform(
            light.transform.translation, light.transform.rotation),
            is_shadow_caster=True).proj_view()
        got = light.proj_view()
        assert got is not before and got.tobytes() == fresh.tobytes()
        before = got
    light.transform.rotation[:] = quat.normalize(np.float32([0.1, 0.9, 0.2,
                                                             0.3]))
    fresh = DirectionalLight(Transform(
        light.transform.translation, light.transform.rotation),
        is_shadow_caster=True).proj_view()
    assert light.proj_view().tobytes() == fresh.tobytes()


@functools.lru_cache(maxsize=1)
def _ibl():
    return scenes.tiny_ibl()


def _tiny(cfg):
    world = scenes.tiny_world()
    world.insert_resource(_ibl())
    world.insert_resource(scenes.camera(cfg))
    return world


def _first_transform(world):
    return next(iter(world.query(Transform, Model)))[0]


TRANSFORM_EDITS = {
    "nothing": (lambda t: None, False),
    "translation_element": (
        lambda t: t.translation.__setitem__(1, t.translation[1] + 0.5), True),
    "rotation_element": (
        lambda t: t.rotation.__setitem__(slice(None), quat.normalize(
            t.rotation + np.float32([0.0, 0.2, 0.0, 0.0]))), True),
    "scale_element": (lambda t: t.scale.__setitem__(2, 1.75), True),
    "translation_replaced": (
        lambda t: setattr(t, "translation",
                          t.translation + np.float32([0.3, 0, 0])), True),
    "rotation_replaced": (
        lambda t: setattr(t, "rotation", quat.from_rotation_y(0.4)), True),
    "scale_replaced": (
        lambda t: setattr(t, "scale", np.float32([2.0, 1.0, 1.0])), True),
    "replaced_by_same_values": (
        lambda t: setattr(t, "translation", t.translation.copy()), False),
}


@pytest.mark.parametrize("edit", list(TRANSFORM_EDITS))
def test_refresh_transforms_rebakes_on_an_edit(edit):
    """One edit of an entity's Transform: a re-bake (a new scene, its
    world matrices those a fresh pack bakes, one ``transform_bakes``) or,
    for no change, the same scene object and no bake."""
    cfg = scenes.tiny_config()
    world = _tiny(cfg)
    scene = pack_scene(world, cfg, "cpu")
    assert refresh_transforms(scene) is scene
    fn, rebakes = TRANSFORM_EDITS[edit]
    fn(_first_transform(world))
    trace.reset()
    got = refresh_transforms(scene)
    assert (got is not scene) == rebakes
    assert trace.snapshot()["counters"].get("transform_bakes", 0) == rebakes
    fresh = pack_scene(world, cfg, "cpu")
    assert np.array_equal(got.mesh_world.numpy(), fresh.mesh_world.numpy())
    assert np.array_equal(got.tri_attrs.numpy(), fresh.tri_attrs.numpy())
    assert refresh_transforms(got) is got
    trace.reset()


def _lookup(r, world):
    """A frame's host side (``Renderer._frame_inputs``, what
    ``render_device`` runs before the frame), then the key the captured
    frame is looked up by on a card."""
    _, quads, has_light = r._frame_inputs(world)
    return r._graph_key(has_light, quads)


def _light(world):
    return next(lt for lt in world.query(DirectionalLight))


def _move_camera(r, world):
    cam = world.resource(Camera)
    cam.transform.translation = cam.transform.translation + np.float32(
        [0.1, 0.0, 0.0])
    cam.refresh_view()


def _move_entity(r, world):
    _first_transform(world).translation[0] += 0.25


def _spawn(r, world):
    world._cube = world.spawn((
        Transform.from_xyz(0.6, 0.3, 0.9),
        procedural_model("cube", base_color=(0.2, 0.9, 0.2, 1.0))))


def _despawn(r, world):
    world.despawn(world._cube)


def _tracer_on(r, world):
    trace.enable()


def _light_on(r, world):
    _light(world).is_shadow_caster = True


KEY_CHANGES = {
    # what builds the key again (a new value)
    "resize": (lambda r, world: r.resize(160, 64), True),
    "prepare": (lambda r, world: r.prepare(world), True),
    "light_goes": (lambda r, world: setattr(_light(world),
                                            "is_shadow_caster", False), True),
    "light_appears": (_light_on, True),
    "extra_pass": (lambda r, world: r.extra_passes.append(RenderPass()),
                   True),
    "tracer": (_tracer_on, True),
    # what keeps it (the same object)
    "camera_move": (_move_camera, False),
    "entity_move": (_move_entity, False),
    "spawn": (_spawn, False),
    "despawn": (_despawn, False),
}


@pytest.mark.parametrize("change", list(KEY_CHANGES))
def test_graph_key_is_built_only_when_a_part_changes(change):
    """The key of the captured frame, over frames' host sides: built again
    (``graph_key_builds``, a key of another value) after a change of its
    program, and the very same object across what a frame meets."""
    cfg = scenes.tiny_config(width=128, height=32)
    world = _tiny(cfg)
    if change == "light_appears":
        _light(world).is_shadow_caster = False
    if change == "despawn":
        _spawn(None, world)
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    trace.disable()
    trace.reset()
    try:
        key = _lookup(r, world)
        assert _lookup(r, world) is key
        builds = trace.snapshot()["counters"]["graph_key_builds"]
        fn, rebuilt = KEY_CHANGES[change]
        fn(r, world)
        got = _lookup(r, world)
        now = trace.snapshot()["counters"]["graph_key_builds"]
        if rebuilt:
            assert got != key and now == builds + 1
        else:
            assert got is key and now == builds
        assert r._prepare_count == 1 + (change == "prepare")
    finally:
        trace.disable()
        trace.reset()


def test_counters_over_a_walk_and_a_spawn():
    """Ten frames of a camera walk: a camera block built every frame, no
    bake and no key build; then a frame with a spawn: one bake (the
    appended rows) and still no key build, and the next frame, with
    nothing changed, builds nothing."""
    cfg = scenes.tiny_config(width=128, height=32)
    world = _tiny(cfg)
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    trace.disable()
    trace.reset()
    _lookup(r, world)  # the warm-up frame

    def counts():
        got = trace.snapshot()["counters"]
        return [got.get(k, 0) for k in ("camera_block_builds",
                                        "transform_bakes",
                                        "graph_key_builds")]

    start = counts()
    for _ in range(10):
        _move_camera(r, world)
        _lookup(r, world)
    walk = counts()
    assert [b - a for a, b in zip(start, walk)] == [10, 0, 0]
    _spawn(r, world)
    _move_camera(r, world)
    _lookup(r, world)
    spawn = counts()
    assert [b - a for a, b in zip(walk, spawn)] == [1, 1, 0]
    _lookup(r, world)
    assert counts() == spawn
    assert r._prepare_count == 1
    trace.reset()
