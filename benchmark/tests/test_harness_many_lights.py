"""The many-light configuration (``sponza_1080p_lights1024``) and the
time-of-day mix (``sunset``): the two cells found by their names with
their metrics; the recipe (``scenes/sponza_many_lights.py``) the stock
scene's but for its 1024 point lights, the same on every seed but the
sky, packed as 1025 light rows; the walk's orbit sees no sky over it;
``sunset.json`` run through the harness on the CPU, ``correct``; and
``shade_kernel_ms.frame`` on a synthetic record."""

import json
import os

import numpy as np
import pytest

from benchmark.harness import main, spec, traffic, world
from benchmark.scenes import sponza_grid, sponza_many_lights

from .conftest import REPO, tiny_root
from .test_harness_metrics import reader, record

LIGHTS = "sponza_1080p_lights1024.walk"
SUNSET = "sponza_1080p.sunset"


def _mix(name):
    with open(os.path.join(REPO, "benchmark", "traffic",
                           f"{name}.json")) as f:
        return json.load(f)


def test_the_two_cells_find_their_config_traffic_and_metrics():
    lights, sunset = spec.load(REPO, LIGHTS), spec.load(REPO, SUNSET)
    assert lights.chips == sunset.chips == 1
    conf = lights.config
    assert conf["scene"] == "sponza_many_lights"
    assert conf["scene_args"] == {"n_grid": 10, "n_points": 1024}
    assert (conf["width"], conf["height"]) == (1920, 1080)
    assert conf["engine"] == {"max_lights": 1025}
    assert conf["reduced"] == []
    stock = spec.load(REPO, "sponza_1080p.walk").config
    assert conf["ibl"] == stock["ibl"] and conf["check"] == stock["check"]
    assert sunset.config == stock
    assert lights.traffic == _mix("walk")
    sun = _mix("sunset")
    assert sunset.traffic == sun
    assert sun["edits"] == [{"kind": "sun", "period_frames": 3600,
                             "elevation": [0.15, 1.0]}]
    assert {k: v for k, v in sun.items() if k not in ("about", "edits")} \
        == {k: v for k, v in _mix("walk").items()
            if k not in ("about", "edits")}
    for cell in (lights, sunset):
        assert {m.name for m in cell.end_to_end} == {"setup_s", "frame_ms",
                                                     "frame_ms_p99"}
    assert {m.name for m in lights.per_layer} == {
        "shading_roofline.frame", "shade_kernel_ms.frame",
        "device_idle_pct.frame"}
    assert {m.name for m in sunset.per_layer} == {
        "fetch_ms", "setup_binning_kernel_ms.frame",
        "device_idle_pct.frame"}
    assert lights.needs("work") and not sunset.needs("work")
    # the control of the new metric: the walk at the stock five rows
    walk = spec.load(REPO, "sponza_1080p.walk")
    assert "shade_kernel_ms.frame" in {m.name for m in walk.per_layer}


def test_the_recipe_is_the_stock_scene_but_its_1024_point_lights():
    a = sponza_many_lights.recipe(7)
    b = sponza_many_lights.recipe(2 ** 31 + 11)
    stock = sponza_grid.recipe(7)
    assert not np.array_equal(a["sky"], b["sky"])
    assert np.array_equal(a["sky"], stock["sky"])
    for key in ("sun", "camera", "plane_half_extent"):
        assert a[key] == b[key] == stock[key]
    assert len(a["entities"]) == len(stock["entities"]) == 101
    for x, y, s in zip(a["entities"], b["entities"], stock["entities"]):
        assert x["translation"] == y["translation"] == s["translation"]
        assert np.array_equal(x["base_color"], s["base_color"])
        assert np.array_equal(x["ormn"], s["ormn"])
        assert np.array_equal(y["primitive"]["indices"],
                              s["primitive"]["indices"])
    assert a["points"] == b["points"]
    assert len(a["points"]) == 1024
    pos = np.array([p["position"] for p in a["points"]])
    assert np.abs(pos[:, [0, 2]]).max() <= 19.5
    assert pos[:, 1].min() >= 0.3 and pos[:, 1].max() <= 4.0
    col = np.array([p["color"] for p in a["points"]])
    # value 1, saturation 0.5-1: the largest channel 1, the smallest 0-0.5
    assert np.allclose(col.max(1), 1.0) and col.min(1).max() <= 0.5
    assert {p["intensity"] for p in a["points"]} == {0.03125}
    assert sum(p["intensity"] for p in a["points"]) == 4 * 8.0


def test_the_world_packs_1025_light_rows():
    rec = sponza_many_lights.recipe(3, n_grid=2)
    api = world.reference_api()
    w = world.build_world(api, rec)
    assert len(list(w.query(api.DirectionalLight))) == 1
    assert len(list(w.query(api.PointLight))) == 1024
    from benchmark.reference.plain.scene.scene_buffers import pack_scene

    scene = pack_scene(w, api.EngineConfig(width=64, height=32,
                                           max_lights=1025), "cpu")
    assert int(scene.num_lights) == 1025
    rows = scene.lights[:1025].numpy()
    assert np.all(rows[0, 0] == 0.0) and np.all(rows[1:, 0] == 1.0)
    # the engine's point light: colour x intensity, the default
    # attenuation (1, 0.09, 0.032), no range
    first = rec["points"][0]
    assert np.allclose(rows[1, 8:11],
                       np.float32(first["color"]) * np.float32(0.03125))
    assert np.allclose(rows[1:, 16:19], [1.0, 0.09, 0.032])
    with pytest.raises(ValueError, match="too many lights"):
        pack_scene(w, api.EngineConfig(width=64, height=32), "cpu")


def test_the_walk_orbit_sees_no_sky_over_the_scene():
    rec = sponza_many_lights.recipe(5)
    st = traffic.Stage(rec, np.pi / 4, 1920 / 1080, 0.1, 1 / 60)
    # the Orbit's constructor runs check_orbit over every pose
    orbit = traffic.Orbit(_mix("walk")["camera"], 5, st)
    traffic.check_orbit(orbit, 19.75, 20.0, st.fov, st.aspect, st.near)


def test_the_sunset_mix_runs_through_the_harness_correct(tmp_path, capsys):
    """``sunset.json`` as it is but its warm-up and trace, on the tiny
    stock configuration: every frame moves the sun, and the frames match
    the reference's render of each frame's pose and sun."""
    root = tiny_root(tmp_path, [("t.sunset", ("sponza_1080p", {}),
                                 "sunset")])
    path = os.path.join(root, "benchmark", "traffic", "sunset.json")
    mix = _mix("sunset")
    mix.update(warmup_frames=2, trace_frames=3)
    with open(path, "w") as f:
        json.dump(mix, f)
    rc = main.main(["--workload", "t.sunset", "--seed", "4294967399",
                    "--seconds", "1.5", "--trace", "0"], root=root,
                   device="cpu")
    assert rc == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert "check first sun frame 0:" in err
    # the tail needs two window frames, which a loaded CPU may not reach
    assert {"setup_s", "frame_ms"} <= set(line["metrics"]) <= {
        "setup_s", "frame_ms", "frame_ms_p99"}


def test_shade_kernel_ms_reads_k9_of_the_probed_frames():
    rec = record()
    assert reader("shade_kernel_ms.frame")({"trace": rec}) == \
        pytest.approx(0.1)
    rec["device_ops"] = [op for op in rec["device_ops"]
                         if not op[0].startswith("shade_kernel")]
    rec["device_ops"].append(("shade_ref_kernel(ShadeRefArgs)", 400.0,
                              500.0))
    assert reader("shade_kernel_ms.frame")({"trace": rec}) is None
    assert reader("shade_kernel_ms.frame")({}) is None
