#!/usr/bin/env python3
"""Hold and time the two shading kernels, K9 (csrc/shading.cu) and K11
(csrc/shading_ref.cu), of several checkouts on light tables of several
lengths, in turns, on one card.

    python3 scripts/torch_ab_lights.py CHECKOUT [CHECKOUT ...] \
        [--rows 5 538 539 1025] [--rounds N]

Run from the root of a checkout with the others unpacked into gitignored
directories (``git archive <parent> | tar -x -C _scratch/parent``); ``.``
names this one.  Each checkout's library is built by its own
kernels/_build.py (scripts/torch_ab_shading_ref.py ``checkout_library``)
and launched through this checkout's wrappers.  The calls: the default
path's K9 call and the reference path's K11 call of scenes.grid_world(10)
from scenes.lit_camera at 1920x1080 (no sky pixel), each with its light
table replaced by ``n`` rows, the scene's sun and ``n - 1`` point lights
of the benchmark's many-light layout (chip_smoke.many_light_rows).

Prints the card's name and power limit; each checkout's registers and
SASS mix of shade_kernel and shade_ref_kernel (chip_smoke.sass_report);
per kernel and table length whether each checkout launches, whether its
colour equals the first checkout's byte for byte (where not, how many
values differ and by how much), and the first
checkout's against the plain version at SHADING_BAR (skipped with
``--no-plain``); then per round the median device ms of 20 launches of
each checkout that launches (chip_smoke.median_ms), the checkouts in
order and then in reverse; and last one JSON line {"launch": {kernel:
{rows: {checkout: error or null}}}, "equal": {kernel: {rows: {checkout:
bool}}}, "plain": {kernel: {rows: [max |err|, ok]}}, "ms": {kernel:
{rows: {checkout: [ms, ...]}}}}.  Exits 1 if the first checkout fails to
launch or its plain check fails.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from torch_ab_shading_ref import checkout_library  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--rows", type=int, nargs="+",
                    default=[5, 538, 539, 1025])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--no-plain", action="store_true")
    opt = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as C
    from mo_renderer_tpu_torch import scenes
    from mo_renderer_tpu_torch.config import EngineConfig
    from mo_renderer_tpu_torch.kernels import _build
    from mo_renderer_tpu_torch.passes import shading as Sh

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = {}
    for i, path in enumerate(opt.checkouts):
        so, libs[path] = checkout_library(os.path.abspath(path), str(i))
        sass = C.sass_report(so)
        for kernel in ("shade_kernel", "shade_ref_kernel"):
            print(f"{path}: {kernel} {json.dumps(sass.get(kernel))}",
                  flush=True)

    cfg = EngineConfig(width=1920, height=1080)
    seen = C.capture_inputs(
        cfg, "cuda", [({}, scenes.grid_world, scenes.lit_camera),
                      (C.PATHS["reference"][0], scenes.grid_world,
                       scenes.lit_camera)], {"shading", "shading_ref"})
    base = {"shading": (C.shading_args(*seen["shading"]), 4,
                        Sh._shading_fast_cuda, Sh._shading_fast_plain),
            "shading_ref": (C.shading_ref_args(*seen["shading_ref"]), 3,
                            Sh._shading_ref_cuda, Sh._shading_ref_plain)}
    calls = {}
    for kernel, (args, at, kern, plain) in base.items():
        print(f"{kernel}@lit: {tuple(args[0].depth.shape)}, "
              f"{int((args[0].depth >= 1.0).sum())} sky pixels", flush=True)
        for n in opt.rows:
            a = list(args)
            a[at], a[at + 1] = C.many_light_rows(args[at], n), n
            calls[kernel, n] = (tuple(a), kern, plain)

    def use(path):
        _build._lib = libs[path]

    def run(path, a, kern):
        use(path)
        try:
            out = kern(*a)
            torch.cuda.synchronize()
            return out, None
        except RuntimeError as exc:
            return None, str(exc).splitlines()[0][:200]

    failed = False
    first = opt.checkouts[0]
    report = {"launch": {}, "equal": {}, "plain": {}, "ms": {}}
    for (kernel, n), (a, kern, plain) in calls.items():
        want, err = run(first, a, kern)
        launch = {first: err}
        equal = {}
        for path in opt.checkouts[1:]:
            got, launch[path] = run(path, a, kern)
            equal[path] = (got is not None and want is not None
                           and torch.equal(got, want))
            if got is not None and want is not None and not equal[path]:
                print(f"{kernel} {n} rows: {path} apart from {first} in "
                      f"{int((got != want).sum())} of {got.numel()} "
                      f"values, by at most "
                      f"{(got - want).abs().max().item():.3g}", flush=True)
        line = f"{kernel} {n} rows: launches {launch}, equal to {first} " \
               f"{equal}"
        failed |= err is not None
        if want is not None and not opt.no_plain:
            e, ok, bar = C.shading_compare(want, plain(*a))
            report["plain"].setdefault(kernel, {})[n] = [e, ok]
            line += f", {first} vs plain max |err| {e:.3g} ok {ok} ({bar})"
            failed |= not ok
        print(line, flush=True)
        report["launch"].setdefault(kernel, {})[n] = launch
        report["equal"].setdefault(kernel, {})[n] = equal
    for r in range(opt.rounds):
        for (kernel, n), (a, kern, _) in calls.items():
            ms = report["ms"].setdefault(kernel, {}).setdefault(n, {})
            for path in opt.checkouts + opt.checkouts[::-1]:
                if report["launch"][kernel][n][path] is None:
                    use(path)
                    ms.setdefault(path, []).append(
                        C.median_ms(functools.partial(kern, *a)))
            print(f"round {r} {kernel} {n} rows: " + "; ".join(
                f"{p} {', '.join(f'{t:.4f}' for t in v[-2:])}"
                for p, v in ms.items()), flush=True)
    print(json.dumps(report))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
