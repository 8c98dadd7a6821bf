"""BENCHMARK.json and the files it names.  Every piece is found by the
name the spec gives it, so a later cell, configuration, traffic mix or
metric is a new file and a new entry, never an edit:

- a cell (``workloads``) names its configuration and its traffic;
- ``configs/<config>.json`` (the configuration's ``file``) holds the
  scene recipe's name and arguments, the size, the EngineConfig
  overrides, the IBL sizes and what the check samples;
- ``traffic/<traffic>.json`` holds the mix's parameters
  (``harness.traffic``);
- ``metrics/<metric>.py`` reads one metric, end-to-end or per-layer,
  from a run's record: ``read(run) -> float | None``; its ``NEEDS``
  names what a traced run has to add to the record for it (``"work"``:
  the reference's work counts of the probed frames);
- ``scenes/<scene>.py`` makes the scene: ``recipe(seed, **scene_args)``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    entry: dict
    read: object  # read(run) -> float | None
    needs: tuple = ()


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    def needs(self, what: str) -> bool:
        """Whether a per-layer metric of the cell needs ``what``."""
        return any(what in m.needs for m in self.per_layer)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _reader(root, name):
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"metric {name}: no reader at {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scene_module(name):
    return importlib.import_module(f"benchmark.scenes.{name}")


def applies(entry, cell, reported=None):
    """Whether a metric entry is the cell's: listed by ``workloads``, or,
    without that key, an end-to-end metric of every cell / a per-layer
    metric of every cell that reports its ``moves``."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return reported is None or entry.get("moves") in reported


def load(root: str, workload: str) -> Cell:
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {', '.join(cells)})")
    w = cells[workload]
    confs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, confs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(root, "benchmark", "traffic",
                                      f"{w['traffic']}.json"))
    def metric(m):
        mod = _reader(root, m["name"])
        return Metric(m["name"], m["unit"], m, mod.read,
                      tuple(getattr(mod, "NEEDS", ())))

    e2e = [metric(m) for m in bench["end_to_end"] if applies(m, w["name"])]
    names = {m.name for m in e2e}
    per = [metric(m) for m in bench["per_layer"]
           if applies(m, w["name"], names)]
    return Cell(w["name"], int(w["chips"]), config, traffic, e2e, per)
