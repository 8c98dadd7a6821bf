"""The harness's tests: ``python -m pytest benchmark/tests -q`` (CPU,
tiny sizes); the ones marked ``cuda`` skip without a card and run on one
by the same command."""

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


TINY_IBL = {"cubemap_size": 16, "irradiance_size": 8, "specular_mips": 3,
            "specular_samples": 8, "brdf_lut_size": 16}


def tiny_root(tmp_path, cells) -> str:
    """A checkout of its own for the harness: the repository's traffic
    mixes and metric readers, and a BENCHMARK.json of ``cells``, each
    (cell name, configuration overrides of the repository's
    configuration, traffic), at a tiny size."""
    root = tmp_path / "root"
    bench = root / "benchmark"
    (bench / "configs").mkdir(parents=True)
    for d in ("traffic", "metrics"):
        shutil.copytree(os.path.join(REPO, "benchmark", d), bench / d)
    path = json.loads((bench / "traffic" / "path.json").read_text())
    path["camera"]["path_frames"] = 8  # a few calls make a whole turn
    (bench / "traffic" / "path.json").write_text(json.dumps(path))
    spec = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    confs, works = [], []
    for name, (base, over), mix in cells:
        conf = json.load(open(os.path.join(REPO, "benchmark", "configs",
                                           f"{base}.json")))
        conf.update(width=128, height=72, scene_args={"n_grid": 3},
                    engine={"shadow_map_size": 256}, ibl=TINY_IBL)
        conf["check"] = dict(conf["check"], frames=2)
        conf.update(over)
        cname = name.split(".")[0]
        (bench / "configs" / f"{cname}.json").write_text(json.dumps(conf))
        confs.append({"name": cname, "source": "https://example.org",
                      "file": f"benchmark/configs/{cname}.json",
                      "reduced": [], "why": "a test"})
        works.append({"name": name, "config": cname, "traffic": mix,
                      "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    spec.update(configs=confs, workloads=works)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(root)
