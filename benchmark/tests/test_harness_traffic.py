"""The traffic's pose and edit schedules."""

import numpy as np
import pytest

from benchmark.harness import traffic, world
from benchmark.scenes import sponza_grid

WALK = {"kind": "orbit", "radius": 10.0, "height": 10.0, "pitch": 1.2,
        "period_frames": 600, "margin": 0.25}
RECIPE = sponza_grid.recipe(1, n_grid=2)
STAGE = traffic.Stage(RECIPE, np.pi / 4, 16 / 9, 0.1, 1 / 60)
SCRIPT = {"kind": "script", "path_frames": 30, "hold": ["W"],
          "press": {"button": "MOUSE_RIGHT", "period": 40, "at": 20},
          "mouse": {"ax": 6.0, "fx": 0.1, "ay": 2.0, "fy": 0.13},
          "window": {"key": "D", "period": 60, "from": 30, "to": 45}}
SPAWN = {"kind": "spawn", "every_frames": 30, "lifetime_frames": 15,
         "size": 1.0, "base_color": [0.2, 1.0], "metallic": [0.0, 1.0],
         "roughness": [0.1, 0.9], "offset": [2.0, 1.5],
         "height": [2.6, 4.0]}


def test_orbit_sees_only_the_plane_and_looks_at_the_centre():
    o = traffic.Orbit(WALK, 12345, STAGE)
    for i in range(0, 600, 7):
        pos, _ = o.pose(i)
        rays = traffic.corner_rays(o.yaw(i), 1.2, np.pi / 4, 16 / 9)
        assert (rays[:, 1] < 0).all()
        hit = pos + rays * (pos[1] / -rays[:, 1])[:, None]
        assert np.abs(hit[:, [0, 2]]).max() <= 19.75 + 1e-6
        ahead = o.ground_ahead(i)
        # the centre ray's ground point lies between the eye and the axis
        assert np.linalg.norm(ahead[[0, 2]]) < np.linalg.norm(pos[[0, 2]])
    # the same seed, the same poses; another seed, another phase
    o2 = traffic.Orbit(WALK, 12345, STAGE)
    o3 = traffic.Orbit(WALK, 12346, STAGE)
    assert np.array_equal(o.pose(17)[0], o2.pose(17)[0])
    assert not np.array_equal(o.pose(17)[0], o3.pose(17)[0])
    assert np.allclose(o.pose(3)[0], o.pose(603)[0])


@pytest.mark.parametrize("change", [{"radius": 19.0}, {"pitch": 0.6},
                                    {"radius": 2.0, "height": 3.0}])
def test_an_orbit_that_would_see_sky_is_refused(change):
    with pytest.raises(ValueError):
        traffic.Orbit(dict(WALK, **change), 1, STAGE)
    # unless the mix says it may: the example's stress camera sees sky
    traffic.Orbit(dict(WALK, sees_sky=True, **change), 1, STAGE)


def test_the_camera_class_looks_where_the_orbit_says():
    api = world.reference_api()
    o = traffic.Orbit(WALK, 99, STAGE)
    for i in (0, 150, 333):
        pos, rot = o.pose(i)
        cam = api.Camera(position=tuple(pos), rotation=rot)
        assert np.allclose(cam.direction(), traffic._forward(o.yaw(i), 1.2),
                           atol=1e-5)
        d = cam.direction()[[0, 2]]
        inward = -pos[[0, 2]] / np.linalg.norm(pos[[0, 2]])
        assert np.dot(d / np.linalg.norm(d), inward) == pytest.approx(
            1.0, abs=1e-5)


def test_edit_schedule_spawns_every_30_and_despawns_15_later():
    orbit = traffic.Orbit(WALK, 7, STAGE)
    e = traffic.Edits([SPAWN], 7, STAGE, orbit)
    ops = {i: e.at(i) for i in range(-5, 95) if e.at(i)}
    assert ops == {0: [("spawn", 0)], 15: [("despawn", 0)],
                   30: [("spawn", 1)], 45: [("despawn", 1)],
                   60: [("spawn", 2)], 75: [("despawn", 2)],
                   90: [("spawn", 3)]}
    s = e.of(traffic.Spawns)
    assert s.live(14) == [0] and s.live(15) == [] and s.live(-1) == []
    assert e.key(14) == ((0,),) and e.key(15) == ((),)
    a = s.entity(3, np.zeros(3))
    b = s.entity(3, np.zeros(3))
    assert a["translation"] == b["translation"]
    assert np.array_equal(a["base_color"], b["base_color"])
    assert 2.6 <= a["translation"][1] <= 4.0
    assert a["textures"] == []
    # by default a spawn stands where the view's centre met the ground
    g = orbit.ground_ahead(90)
    t = s.entity(3)["translation"]
    assert abs(t[0] - g[0]) <= 2.0 and abs(t[2] - g[2]) <= 1.5
    with pytest.raises(ValueError):
        traffic.Edits([dict(SPAWN, every_frames=10, lifetime_frames=10)],
                      1, STAGE, orbit)
    with pytest.raises(ValueError):
        traffic.Edits([{"kind": "no_such_edit"}], 1, STAGE, orbit)


def test_edits_apply_to_a_live_world_as_build_makes_it():
    """Frame by frame edits of a live world (spawns, despawns and the
    turning sun) leave it as ``build`` makes it from the recipe."""
    api = world.reference_api()
    orbit = traffic.Orbit(WALK, 3, STAGE)
    sun = {"kind": "sun", "period_frames": 40, "elevation": [0.2, 1.2]}
    e = traffic.Edits([SPAWN, sun], 3, STAGE, orbit)
    live, spawned = world.build_world(api, RECIPE), {}

    def state(w):
        light = next(x for x in w.query(api.DirectionalLight)
                     if x.is_shadow_caster)
        cubes = sorted(tuple(t.translation) for t, _ in w.query(
            api.Transform, api.Model))
        return light.proj_view(), cubes

    suns = set()
    for i in range(-3, 50):
        e.apply(api, live, i, spawned)
        fresh = world.build_world(api, RECIPE)
        e.build(api, fresh, i)
        (pv_a, cubes_a), (pv_b, cubes_b) = state(live), state(fresh)
        assert np.array_equal(pv_a, pv_b) and cubes_a == cubes_b
        suns.add(e.key(i)[1])
        assert ("sun", i) in e.at(i)
    assert len(suns) == 40  # a new place every frame of its period
    s = e.of(traffic.Sun)
    y = [s.position(i)[1] for i in range(40)]
    d = np.linalg.norm(np.array(s.position(7)) - s.target)
    assert d == pytest.approx(np.linalg.norm(
        np.array(RECIPE["sun"]["position"]) - s.target))
    assert min(y) == pytest.approx(d * np.sin(0.2), rel=1e-2)
    assert max(y) == pytest.approx(d * np.sin(1.2), rel=1e-6)


def test_scripted_path_is_the_same_on_both_sides():
    """The script fed to the port's and to the reference's
    Camera.update_camera makes the same poses; the views' rig of each
    side's cameras makes the same views."""
    from benchmark.harness.views import camera_path

    sides = [traffic.Script(SCRIPT, 5, STAGE, api=api)
             for api in (world.port_api(), world.reference_api())]
    for i in range(-2, 33):
        for a, b in zip(sides[0].pose(i), sides[1].pose(i)):
            assert np.array_equal(a, b)
    assert not np.allclose(sides[0].pose(0)[0], sides[0].pose(29)[0])
    assert np.array_equal(sides[1].pose(3)[0], sides[1].pose(33)[0])

    class Run:
        class cell:
            config = {"width": 64, "height": 36, "views": 3}

    script = traffic.camera(SCRIPT, 5, STAGE)
    paths = [camera_path(api, Run, script)
             for api in (world.port_api(), world.reference_api())]
    assert len(paths[0]) == 30 and len(paths[0][0]) == 3
    for a, b in zip(*paths):
        for ca, cb in zip(a, b):
            assert np.array_equal(ca.view(), cb.view())
            assert np.array_equal(ca.prev_view(), cb.prev_view())
    with pytest.raises(ValueError):
        traffic.camera({"kind": "no_such_camera"}, 1, STAGE)


def test_the_recipe_is_the_examples_scene():
    r = sponza_grid.recipe(3)
    assert len(r["entities"]) == 101
    tris = sum(len(e["primitive"]["indices"]) // 3 for e in r["entities"])
    assert tris == 51802
    assert len(r["points"]) == 4
    assert sum(bool(e["textures"]) for e in r["entities"]) == 21
    assert np.array_equal(r["sky"], sponza_grid.recipe(3)["sky"])
    assert not np.array_equal(r["sky"], sponza_grid.recipe(4)["sky"])
