"""Each piece found by its name, and a cell made of new files only."""

import json
import os

import pytest

from benchmark.harness import main, spec

from .conftest import REPO, tiny_root


def test_every_cell_of_the_spec_finds_its_pieces():
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = spec.load(REPO, w["name"])
        assert cell.chips == w["chips"]
        assert cell.traffic["loop"] in ("frames", "views")
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(m.read)
        spec.scene_module(cell.config["scene"])


def test_a_metric_applies_by_its_workloads_or_its_moves():
    assert spec.applies({"workloads": ["a"]}, "a")
    assert not spec.applies({"workloads": ["a"]}, "b")
    assert spec.applies({"moves": "x"}, "b", {"x"})
    assert not spec.applies({"moves": "x"}, "b", {"y"})


def test_an_unknown_workload_or_reader_is_refused(tmp_path):
    with pytest.raises(KeyError):
        spec.load(REPO, "no.such")
    root = tiny_root(tmp_path, [("t.walk", ("sponza_1080p", {}), "walk")])
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["per_layer"].append({"name": "no_reader", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "x", "moves": "frame_ms"})
    open(os.path.join(root, "BENCHMARK.json"), "w").write(json.dumps(bench))
    with pytest.raises(FileNotFoundError):
        spec.load(root, "t.walk")


# new mixes as data only, each of a kind no cell of the repository has:
# the example's stress camera (an orbit that sees sky) with a turning
# sun, and the scripted flythrough in the app loop with spawns and a sun
STRESS_ORBIT = {"kind": "orbit", "radius": 14.0, "height": 4.0,
                "pitch": -0.2, "period_frames": 50, "sees_sky": True}
SUNSET = {"kind": "sun", "period_frames": 40, "elevation": [0.15, 1.0]}
MIXES = {
    "orbit_sunset": {"camera": STRESS_ORBIT, "edits": [SUNSET]},
    "script_spawns": {"camera": "path", "edits": [
        SUNSET, {"kind": "spawn", "every_frames": 4, "lifetime_frames": 2,
                 "size": 1.0, "base_color": [0.2, 1.0],
                 "metallic": [0.0, 1.0], "roughness": [0.1, 0.9],
                 "offset": [2.0, 1.5], "height": [2.6, 4.0]}]},
}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_a_new_config_mix_and_metric_run_as_new_files(tmp_path, capsys,
                                                      mix):
    """A dummy configuration, traffic mix and per-layer metric, added as
    files only, run through the harness on the CPU: the mix moves the
    camera and edits the world in ways no repository mix does, and the
    run's frames still match the reference's render of each frame's
    pose and world."""
    root = tiny_root(tmp_path, [("dummy.mix", ("sponza_1080p", {}),
                                 "dummy_mix")])
    traffic = json.load(open(os.path.join(REPO, "benchmark", "traffic",
                                          "walk.json")))
    camera = MIXES[mix]["camera"]
    if camera == "path":
        camera = json.load(open(os.path.join(
            REPO, "benchmark", "traffic", "path.json")))["camera"]
        camera["path_frames"] = 30
    traffic.update(camera=camera, edits=MIXES[mix]["edits"],
                   warmup_frames=2, trace_frames=3)
    with open(os.path.join(root, "benchmark", "traffic", "dummy_mix.json"),
              "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(root, "benchmark", "metrics",
                           "frames_counted.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run['frame_s']))\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["per_layer"] = [{"name": "frames_counted", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "app loop", "moves": "frame_ms"}]
    open(os.path.join(root, "BENCHMARK.json"), "w").write(json.dumps(bench))
    for trace in ("0", "1"):
        # a frame that redraws its shadow map takes ~0.1-0.6 s on a CPU: the
        # window holds a few, so that the tail has frames to read
        rc = main.main(["--workload", "dummy.mix", "--seed", "4294967397",
                        "--seconds", "1.5", "--trace", trace], root=root,
                       device="cpu")
        assert rc == 0
        out, err = capsys.readouterr()
        line = json.loads(out.strip().splitlines()[-1])
        assert line["correct"] is True
        # the window's first frame carries its first edits, and is checked
        first = {"orbit_sunset": "sun", "script_spawns": "repack+sun"}[mix]
        assert f"check first {first} frame 0:" in err
        if trace == "0":
            assert set(line["metrics"]) == {"setup_s", "frame_ms",
                                            "frame_ms_p99"}
        else:
            assert line["metrics"]["frames_counted"]["value"] >= 1
