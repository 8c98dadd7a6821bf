"""The control of the check: the plain reference put in the program's
place and computed one precision below the configuration's (float32
products in TF32), judged as a run's frames are.  It has to come out as
not correct.  It needs no window: for each seed it renders the frames a
run would sample (``frames`` of them, drawn from the seed over one
period of the traffic) both ways.

    python -m benchmark.harness.control --workload <cell> --seeds 1 2 3

prints one JSON line per seed with the numbers the check compares, and
whether the limits pass them (they must not)."""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from . import check, traffic, world
from .main import ROOT, make_run


def readings(run, n_frames: int) -> dict:
    """The check's numbers of the TF32 control against the reference on
    ``n_frames`` frames of ``run``'s traffic, each made as a run's check
    makes its reference frames."""
    conf, tr = run.cell.config, run.cell.traffic
    rng = np.random.default_rng([run.seed, 6])
    rapi = world.reference_api()
    cam, edits = traffic.schedule(run, rapi)
    tally = check.Tally()
    if tr["loop"] == "frames":
        from .frames import reference_frames

        cfg = rapi.EngineConfig(width=conf["width"], height=conf["height"])
        keys = [int(i) for i in rng.integers(0, cam.period, n_frames)]
        for (i, r0, c0), (_, r1, c1) in zip(
                reference_frames(cam, edits, keys, run.reference_cache(),
                                 cfg),
                reference_frames(cam, edits, keys,
                                 run.reference_cache(tf32=True), cfg)):
            tally.add(r1.render(c1), r0.render(c0), f"frame {i}")
    else:
        from .views import camera_path

        path = camera_path(rapi, run, cam)
        r0 = run.reference_cache()((), lambda w: None)
        r1 = run.reference_cache(tf32=True)((), lambda w: None)
        for _ in range(n_frames):
            p = int(rng.integers(0, len(path)))
            g = int(rng.integers(0, len(path[p])))
            tally.add(r1.render(path[p][g]), r0.render(path[p][g]),
                      f"step {p} view {g}")
    nums = tally.numbers()
    ok, checks = check.judge(nums, conf["check"]["limits"], tally.frames)
    return {"seed": run.seed, "frames": tally.frames, "numbers": nums,
            "passes_limits": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    failed_to_fail = 0
    for seed in a.seeds:
        run = make_run(ROOT, ["--workload", a.workload, "--seed", str(seed),
                              "--seconds", "1"], device=a.device)
        n = a.frames or int(run.cell.config["check"]["frames"])
        out = readings(run, n)
        failed_to_fail += out["passes_limits"]
        print(json.dumps(out), flush=True)
    return 1 if failed_to_fail else 0


if __name__ == "__main__":
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    os.environ.setdefault("NCCL_SHM_DISABLE", "1")
    sys.exit(main())
