#!/usr/bin/env python3
"""Time the tail of ``Renderer.render`` on one card, the ways below in
turns: the frame's fetch to host memory and the drain of its dropped-pair
counts.

    python3 scripts/torch_ab_fetch.py [--rounds N] [--fetches N]
        [--width W] [--height H]

``pageable``: the frame's ``.cpu()`` into a freshly allocated pageable
tensor and its byte view (``unpack_rgba8`` before the pinned path), then
``check_overflow`` reading the two device counts with ``int()``.
``pinned``: ``Renderer.stage_overflow`` (the counts' non-blocking copies
into page-locked memory), ``unpack_rgba8`` (the frame's asynchronous copy
into page-locked memory and one wait on an event after it), then
``check_overflow`` reading host integers.  ``pageable_reused``, which
no program runs: ``pageable`` with the frame copied into one pageable
tensor kept across fetches, which tells the copy from the first touch of
fresh host pages.  Each fetch starts with the
frame finished on the device (a synchronise before it), so the times are
the copy's and the host's, without a frame's work to wait for.  A round
makes ``--fetches`` of each way, the ways in turns (in order in even
rounds, in reverse in odd ones); the frame is dropped after each fetch,
as the benchmark's loop drops the frames it does not keep.

Prints the card's name and power limit, per round and way the median host
ms of the fetch, of the drain and of both, the fetch's median device ms
between CUDA events and its GB/s over the host ms; and last one JSON line
{"card", "power_limit", "bytes", "rounds": [...], "median": {way: {...}}}.
Exits 1 if the pageable and pinned bytes differ or if the pinned frame
is not in page-locked memory.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mo_renderer_tpu_torch import Renderer, scenes  # noqa: E402
from mo_renderer_tpu_torch.passes.present import unpack_rgba8  # noqa: E402


WAYS = ("pageable", "pinned", "pageable_reused")


def unpack_pageable(packed) -> np.ndarray:
    """``unpack_rgba8`` as it was before the pinned path."""
    packed = packed.cpu().numpy()
    packed = np.ascontiguousarray(np.asarray(packed).view("<u4"))
    return packed.view(np.uint8).reshape(packed.shape + (4,))


def _root(a):
    while isinstance(a, np.ndarray):
        a = a.base
    return a


def _card():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(0), "unknown"
    name, limit = (x.strip() for x in out.split(","))
    return name, limit


def one(way, renderer, packed, counts, kept=None):
    """(fetch host s, drain host s, fetch device ms, frame) of one fetch;
    ``kept`` is the pageable tensor of ``pageable_reused``."""
    renderer._pending_overflow = [c.clone() for c in counts]
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record(stream)
    if way == "pageable":
        frame = unpack_pageable(packed)
    elif way == "pageable_reused":
        frame = unpack_pageable(kept.copy_(packed))
    else:
        renderer.stage_overflow()
        frame = unpack_rgba8(packed)
    end.record(stream)
    t1 = time.perf_counter()
    renderer.check_overflow()
    t2 = time.perf_counter()
    end.synchronize()
    return t1 - t0, t2 - t1, start.elapsed_time(end), frame


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--fetches", type=int, default=200)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card, limit = _card()
    print(f"card: {card}, power limit {limit}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    packed = torch.randint(-2**31, 2**31 - 1, (args.height, args.width),
                           dtype=torch.int32, device="cuda", generator=gen)
    nbytes = packed.numel() * packed.element_size()
    counts = [torch.zeros(2, dtype=torch.int64, device="cuda")
              for _ in range(2)]  # the frame's counts and a shadow's
    renderer = Renderer(scenes.tiny_config(), "cuda")

    want = unpack_pageable(packed)
    got = unpack_rgba8(packed)
    ok = np.array_equal(want, got) and _root(got).is_pinned()
    print(f"bytes equal and pinned: {ok}", flush=True)
    kept = torch.empty_like(packed, device="cpu")
    for way in WAYS:  # warm each way's allocator
        for _ in range(10):
            one(way, renderer, packed, counts, kept)

    rounds = []
    for r in range(args.rounds):
        order = WAYS if r % 2 == 0 else WAYS[::-1]
        row = {}
        for way in order:
            fetch_s, drain_s, dev_ms = [], [], []
            for _ in range(args.fetches):
                f, d, ms, _frame = one(way, renderer, packed, counts, kept)
                fetch_s.append(f)
                drain_s.append(d)
                dev_ms.append(ms)
            fetch = statistics.median(fetch_s)
            row[way] = {
                "fetch_ms": fetch * 1e3,
                "drain_ms": statistics.median(drain_s) * 1e3,
                "both_ms": statistics.median(
                    a + b for a, b in zip(fetch_s, drain_s)) * 1e3,
                "device_ms": statistics.median(dev_ms),
                "gb_per_s": nbytes / fetch / 1e9,
            }
            print(f"round {r} {way:9s} " + "  ".join(
                f"{k} {v:.4f}" for k, v in row[way].items()), flush=True)
        rounds.append(row)
    median = {way: {k: statistics.median(row[way][k] for row in rounds)
                    for k in rounds[0][way]}
              for way in WAYS}
    print(json.dumps({"card": card, "power_limit": limit, "bytes": nbytes,
                      "equal_and_pinned": ok, "rounds": rounds,
                      "median": median}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
