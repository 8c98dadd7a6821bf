#!/usr/bin/env python3
"""The host side of a frame cell's frames on one card, split by the port's
tracer: one checkout, one process.

    python3 scripts/torch_ab_host.py [--root DIR] [--workload CELL]
        [--seed N] [--seconds S]

Imports the port and the benchmark harness from ``--root`` (default: this
checkout), so two checkouts can be run in turns from one command.  Builds
the cell's frame loop (``benchmark/harness/frames.py`` ``FrameLoop``) and
its warm-up, then two windows of ``--seconds`` each: the first with the
tracer off (``frame_ms``: window time over frames, and the median), the
second with it on, read by ``benchmark/harness/program.py``:
``render_device_host_ms`` and ``window_split`` (host ms a frame of each
span, children counted in their parents too).  Prints one JSON line:
{"root", "card", "power_limit", "workload", "seed", "off": {...},
"on": {"frame_ms", "render_device_host_ms", "split", "counters"}}, where
``counters`` are the tracer's counters' growth over the traced window,
and "setup" the counters set-up left (the prepares, the light rows the
prepares packed).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SPLIT = ("frame", "runtime_systems", "render", "render_device",
         "sync_topology", "refresh_transforms", "frame_params", "shadow_memo",
         "graph_lookup", "replay", "note_overflow", "fetch", "fetch_issue",
         "fetch_wait", "check_overflow")


def _card():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return None, None
    name, limit = (x.strip() for x in out.split(","))
    return name, limit


def _frames(loop, seconds):
    """Frames of the traffic until ``seconds`` have passed: their host
    seconds and the window's."""
    frame_s = []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        loop.app.render_frame()
        t1 = time.perf_counter()
        frame_s.append(t1 - t0)
        loop.i += 1
        if t1 - t_start >= seconds:
            return frame_s, t1 - t_start


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--workload", default="sponza_1080p.walk")
    ap.add_argument("--seed", type=int, default=2147483951)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
        root, "benchmark", ".cache", "torch_extensions")

    import torch

    from benchmark.harness import frames, main as harness, program
    from mo_renderer_tpu_torch.utils import trace

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    run = harness.make_run(root, ["--workload", args.workload, "--seed",
                                  str(args.seed), "--seconds",
                                  str(args.seconds)])
    loop = frames.FrameLoop(run)
    loop.warm_up()
    run.sync()

    frame_s, window_s = _frames(loop, args.seconds)
    off = {"frames": len(frame_s),
           "frame_ms": 1e3 * window_s / len(frame_s),
           "frame_ms_median": 1e3 * statistics.median(frame_s)}

    prog = {}

    def point(name):
        snap = trace.snapshot()
        prog[name] = {"counters": snap["counters"],
                      "n_spans": len(snap["spans"])}

    trace.enable()
    try:
        point("window_start")
        frame_s, window_s = _frames(loop, args.seconds)
        point("window_end")
    finally:
        trace.disable()
    prog["spans"] = trace.snapshot()["spans"]
    prog["traced_start"], prog["traced_end"] = (prog["window_start"],
                                                prog["window_end"])
    rec = {"program": prog, "frame_s": frame_s}
    split = program.window_split(rec)["all"]
    start, end = (prog["window_start"]["counters"],
                  prog["window_end"]["counters"])
    card, limit = _card()
    print(json.dumps({
        "root": root, "card": card, "power_limit": limit,
        "workload": args.workload, "seed": args.seed, "off": off,
        "setup": {k: start[k] for k in ("prepares", "light_rows")
                  if k in start},
        "on": {"frames": len(frame_s),
               "frame_ms": 1e3 * window_s / len(frame_s),
               "render_device_host_ms": program.render_device_host_ms(rec),
               "split": {k: split.get(k) for k in SPLIT},
               "counters": {k: v - start.get(k, 0) for k, v in end.items()
                            if not k.startswith("launches.")
                            and v != start.get(k, 0)}},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
