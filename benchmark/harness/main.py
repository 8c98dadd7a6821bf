"""One run of one cell: ``main(argv)`` parses the driver's arguments,
looks for the cards the cell asks for, runs the cell's loop
(``frames``/``views``), reads its metrics, checks its frames and prints
the result as the last line of stdout."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

# top-level modules no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "mo_renderer_tpu")

# when the process started (run.py sets it): set-up counts from there
T0 = None

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Run:
    """What a loop needs: the cell, the seed, the window, the device and
    the plain reference's renderers (made after the window)."""

    def __init__(self, root, args, cell, device, t0):
        from .spec import scene_module

        self.root = root
        self.cell = cell
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.device = device
        self.t0 = t0
        conf = cell.config
        self.recipe = scene_module(conf["scene"]).recipe(
            self.seed, **conf.get("scene_args", {}))

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self):
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def reference_cache(self, tf32: bool = False):
        """``get(key, add)``: a ReferenceRenderer prepared on the recipe's
        world with ``add(world)``'s entities, one per ``key``; the IBL
        maps computed once, from the same panorama as the port's.  With
        ``tf32`` (the control) the maps and the frames compute their
        float32 products in TF32."""
        from ..reference.render import ReferenceRenderer, ibl_maps, tf32_mode
        from . import world

        conf = self.cell.config
        api = world.reference_api()
        cfg = api.EngineConfig(width=conf["width"], height=conf["height"],
                               **conf["engine"])
        with tf32_mode(tf32):
            maps = ibl_maps(self.recipe["sky"], conf["ibl"], self.device)
        cache = {}

        def get(key, add):
            if key not in cache:
                w = world.build_world(api, self.recipe)
                add(w)
                ref = ReferenceRenderer(cfg, maps, self.device, tf32=tf32)
                ref.prepare(w)
                cache[key] = ref
            return cache[key]
        return get


def make_run(root, argv, rank=0, device=None):
    """The Run of ``argv`` on rank ``rank``'s card (or ``device``)."""
    import torch

    from . import spec

    t0 = T0 if T0 is not None and rank == 0 else time.perf_counter()
    args = parse(argv)
    cell = spec.load(root, args.workload)
    if device is None:
        device = torch.device("cuda", rank)
    return Run(root, args, cell, torch.device(device), t0)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _mean(xs):
    xs = [x for x in xs if x is not None]
    return statistics.fmean(xs) if xs else None


def result(run, records, limits) -> dict:
    """The last line: every rank's record read by the cell's metrics
    (the per-layer ones in a traced run, averaged over the ranks)."""
    import torch

    from . import check, trace

    r0 = records[0]
    metrics = {}
    wanted = run.cell.per_layer if run.trace else run.cell.end_to_end
    for m in wanted:
        v = (_mean([m.read(r) for r in records]) if run.trace
             else m.read(r0))
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    tally = check.Tally()
    for r in records:
        tally.merge(r["tally"])
    ok, checks = check.judge(tally.numbers(), limits, tally.frames)
    failed = r0["failed"]  # the overflow check is collective: one count
    cuda = run.device.type == "cuda"
    device = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
        "count": len(records),
        "memory_peak_bytes": max(r["memory_peak_bytes"] for r in records),
    }
    line = {"correct": ok and failed == 0, "attempted": r0["attempted"],
            "failed": failed, "metrics": metrics, "device": device}
    if run.trace:
        traces = [r["trace"] for r in records]
        device["busy_s"] = _mean([trace.busy_us(t) / 1e6 for t in traces])
        device["window_s"] = _mean([(lambda w: (w[1] - w[0]) / 1e6)(
            trace.window(t)) for t in traces])
        line["breakdown"] = trace.breakdown(traces[0])
    check.report(checks, tally.frames)
    line["checks"] = checks
    return line


def main(argv, root=ROOT, device=None) -> int:
    """Run one cell; 0 and a result line, or another code and none.
    ``device`` (tests only) runs on that device with no look for cards."""
    import torch

    args = parse(argv)
    from . import spec

    cell = spec.load(root, args.workload)
    if device is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < cell.chips:
            print(f"benchmark: {cell.name} needs {cell.chips} CUDA "
                  f"device(s), found {n}", file=sys.stderr)
            return 2
    run = make_run(root, argv, device=device)
    limits = cell.config["check"]["limits"]
    if cell.traffic["loop"] == "frames":
        from .frames import run_frames

        records = [run_frames(run)]
    elif cell.traffic["loop"] == "views":
        from .views import run_views

        records = run_views(run, argv, device)
    else:
        raise ValueError(f"traffic loop {cell.traffic['loop']!r}")
    # this process's modules, and those each rank's process held once
    # its own window and check were done
    found = {f"{m} (rank 0)" for m in forbidden_modules()}
    found |= {f"{m} (rank {r})" for r, rec in enumerate(records)
              for m in rec.get("forbidden", ())}
    if found:
        print(f"benchmark: the run imported {', '.join(sorted(found))}",
              file=sys.stderr)
        return 3
    line = result(run, records, limits)
    print(json.dumps(line), flush=True)
    return 0
