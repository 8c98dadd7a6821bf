#!/usr/bin/env python3
"""Hold and time the fast path's shading kernel K9 (csrc/shading.cu) of
several checkouts on the same inputs, in turns, on one card.

    python3 scripts/torch_ab_shading.py CHECKOUT [CHECKOUT ...] \
        [--rounds N]

Run from the root of a checkout (whose package and chip_smoke.py capture
the inputs) with the others unpacked into gitignored directories, e.g.
``git archive <parent> | tar -x -C _scratch/parent``; ``.`` names this
one.  Each checkout's library is built by its own kernels/_build.py (as
scripts/torch_ab_shading_ref.py builds K11's) and K9 is launched from it
through this checkout's wrapper (passes/shading.py
``_shading_fast_cuda``).  A checkout's ShadeArgs must be this one's, or
this one's without the trailing debug pointer ``dbg`` (a checkout from
before K9 wrote its full-rate choices): such a kernel reads the same
fields at the same offsets and never the pointer, and its full-rate
choices are not held.

The calls: the default path's 1920x1080 call on the tiny scene (``tiny``),
on scenes.grid_world(10) (``grid``) and on that scene from
scenes.lit_camera (``lit``, no sky pixel), and on that view under the
full-rate knob set (1, False, False) (``lit full rate``: the specular taps
and the PCF at every pixel), all timed; and, held but not timed,
chip_smoke.shading_option_calls on the budget scene and on the sky-free
view.

Prints the card's name and power limit; each checkout's registers and
SASS mix of shade_kernel (chip_smoke.sass_report); each checkout's
check on each call (the colour at SHADING_BAR, the discrete choices apart
through chip_smoke.shading_choices); then per timed call and round the
median device ms of 20 launches of each checkout (chip_smoke.median_ms),
the checkouts in order and then in reverse; and last one JSON line
{"apart": {checkout: {call: n}}, "ms": {call: {checkout: [ms, ...]}}}.
Exits 1 if a colour check fails, or if a choice is apart in this
checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from torch_ab_shading_ref import checkout_library  # noqa: E402


class PrefixLayout:
    """A checkout's library whose ShadeArgs is this one's without the
    trailing ``dbg`` pointer: the wrapper's size check sees this one's."""

    def __init__(self, lib, size):
        self._lib, self._size = lib, size

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def mo_shading_args_size(self):
        return self._size


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
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
    size = ctypes.sizeof(Sh.ShadeArgs)
    libs, full = {}, {}
    for i, path in enumerate(opt.checkouts):
        so, lib = checkout_library(os.path.abspath(path), str(i))
        got = lib.mo_shading_args_size()
        full[path] = got == size
        if not full[path] and got != Sh.ShadeArgs.dbg.offset:
            raise RuntimeError(f"{path}: ShadeArgs of {got} bytes fits "
                               "neither layout")
        libs[path] = lib if full[path] else PrefixLayout(lib, size)
        sass = C.sass_report(so).get("shade_kernel")
        print(f"{path}: shade_kernel {json.dumps(sass)}, full-rate choices "
              f"{'held' if full[path] else 'not written'}", flush=True)

    cfg = EngineConfig(width=1920, height=1080)
    frames = {"tiny": ({}, scenes.tiny_world, scenes.camera),
              "grid": ({}, scenes.grid_world, scenes.grid_camera),
              "lit": ({}, scenes.grid_world, scenes.lit_camera),
              "lit full rate": (
                  {"checkerboard": False, "ssao_res_divisor": 1,
                   "pcf_res_divisor": 1, "spec_parent_mip_half_res": False,
                   "spec_mirror_half_res": False},
                  scenes.grid_world, scenes.lit_camera)}
    timed = {}
    for name, frame in frames.items():
        seen = C.capture_inputs(cfg, "cuda", [frame], {"shading"})
        timed[name] = C.shading_args(*seen["shading"])
        print(f"{name}: {tuple(timed[name][0].depth.shape)}, "
              f"{int((timed[name][0].depth >= 1.0).sum())} sky pixels",
              flush=True)
    calls = dict(timed)
    for lit in (False, True):
        for what, args in C.shading_option_calls(cfg, "cuda", lit).items():
            calls[f"{'lit' if lit else 'budget'} {what}"] = args

    def use(path):
        _build._lib = libs[path]

    failed = False
    apart = {path: {} for path in opt.checkouts}
    for name, args in calls.items():
        want = Sh._shading_fast_plain(*args)
        for path in opt.checkouts:
            use(path)
            err, ok, bar = C.shading_compare(Sh._shading_fast_cuda(*args),
                                             want)
            counts = {k: v for k, v in C.shading_choices(args)[0].items()
                      if full[path] or "full" not in k}
            apart[path][name] = sum(n for n, _ in counts.values())
            shown = {k: f"{n} of {of}" for k, (n, of) in counts.items()}
            print(f"check {name} {path}: max |err| {err:.3g}, ok {ok}, "
                  f"apart {apart[path][name]}: {shown}", flush=True)
            failed |= not ok or (path == "." and apart[path][name] > 0)
    times = {name: {path: [] for path in opt.checkouts} for name in timed}
    for r in range(opt.rounds):
        for name, args in timed.items():
            kernel = functools.partial(Sh._shading_fast_cuda, *args)
            for path in opt.checkouts + opt.checkouts[::-1]:
                use(path)
                times[name][path].append(C.median_ms(kernel))
            print(f"round {r} {name}: " + "; ".join(
                f"{p} {', '.join(f'{t:.4f}' for t in times[name][p][-2:])}"
                for p in opt.checkouts), flush=True)
    print(json.dumps({"apart": apart, "ms": times}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
