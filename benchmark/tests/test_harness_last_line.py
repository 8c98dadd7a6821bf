"""The last line's shape, the check's numbers beside their limits, and
the look for JAX in sys.modules."""

import json
import os
import sys
import types

from benchmark.harness import check, main

from .conftest import tiny_root


def test_the_last_line_has_the_keys_and_the_checks_last(tmp_path, capsys):
    root = tiny_root(tmp_path, [("t.path", ("multi_view_4k",
                                            {"views": 2,
                                             "steps_per_call": 2}),
                                 "path")])
    rc = main.main(["--workload", "t.path", "--seed", "7", "--seconds",
                    "0.5", "--trace", "0"], root=root, device="cpu")
    assert rc == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(check.NUMBERS)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    tail = err.strip().splitlines()[-2:]
    assert [t.split()[1] for t in tail] == list(check.NUMBERS)


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    assert main.forbidden_modules() == []
    import mo_renderer_tpu_torch  # noqa: F401  (begins with the name)

    assert main.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        types.ModuleType("jaxlib.xla_client"))
    monkeypatch.setitem(sys.modules, "mo_renderer_tpu",
                        types.ModuleType("mo_renderer_tpu"))
    assert main.forbidden_modules() == ["jaxlib", "mo_renderer_tpu"]


def test_judge_needs_a_frame_and_every_number_under_its_limit():
    limits = {"max_gap_lsb": 2, "share_over_1_lsb": 0.01}
    assert check.judge({"max_gap_lsb": 2, "share_over_1_lsb": 0.0},
                       limits, 1)[0]
    assert not check.judge({"max_gap_lsb": 3, "share_over_1_lsb": 0.0},
                           limits, 1)[0]
    assert not check.judge({"max_gap_lsb": 0, "share_over_1_lsb": 0.0},
                           limits, 0)[0]


def test_views_over_two_ranks_on_the_cpu(tmp_path, capsys):
    """The 4-card cell's path at two gloo ranks, one process each: every
    rank's views checked, the views of both counted."""
    root = tiny_root(tmp_path, [("t2.path", ("multi_view_4k_4cards",
                                             {"views": 3,
                                              "steps_per_call": 2,
                                              "chips": 2}), "path")])
    bench = json.load(open(f"{root}/BENCHMARK.json"))
    bench["workloads"][0]["chips"] = 2
    open(f"{root}/BENCHMARK.json", "w").write(json.dumps(bench))
    rc = main.main(["--workload", "t2.path", "--seed", "11", "--seconds",
                    "0.5", "--trace", "1"], root=root, device="cpu")
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["count"] == 2
    assert line["attempted"] % 6 == 0


PLANT = '''import os
import sys
import types

# a metric reader every rank's process loads: the ranks other than the
# one that prints the result plant a module named jax
if os.getpid() != int(os.environ["PLANTING_PARENT"]):
    sys.modules.setdefault("jax", types.ModuleType("jax"))


def read(run):
    return None
'''


def test_a_rank_that_holds_jax_fails_the_run(tmp_path, capsys, monkeypatch):
    """Two gloo ranks; the second rank's process holds a module named
    ``jax`` once its window and check are done: no result, another code
    than 0, and the rank named on stderr."""
    root = tiny_root(tmp_path, [("t2.path", ("multi_view_4k_4cards",
                                             {"views": 2,
                                              "steps_per_call": 2,
                                              "chips": 2}), "path")])
    bench = json.load(open(f"{root}/BENCHMARK.json"))
    bench["workloads"][0]["chips"] = 2
    bench["per_layer"].append({"name": "planted", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "device", "moves": "views_per_s"})
    open(f"{root}/BENCHMARK.json", "w").write(json.dumps(bench))
    with open(f"{root}/benchmark/metrics/planted.py", "w") as f:
        f.write(PLANT)
    monkeypatch.setenv("PLANTING_PARENT", str(os.getpid()))
    assert "jax" not in sys.modules
    rc = main.main(["--workload", "t2.path", "--seed", "12", "--seconds",
                    "0.3", "--trace", "0"], root=root, device="cpu")
    out, err = capsys.readouterr()
    assert rc != 0
    assert out.strip() == ""
    assert "jax (rank 1)" in err
    assert "jax" not in sys.modules
