"""The comparison that decides ``correct``: frames that the timed path
produced, fetched after the window, against the plain reference's render
of the same inputs (``benchmark.reference``).  Two numbers over all the
sampled frames' colour channels, each held to its limit from the
configuration's ``check.limits``:

- ``max_gap_lsb``: the widest gap of a channel, in 8-bit steps;
- ``share_over_1_lsb``: the share of channels more than one step apart.
"""

from __future__ import annotations

import sys

import numpy as np

NUMBERS = ("max_gap_lsb", "share_over_1_lsb")


def gaps(frame: np.ndarray, ref: np.ndarray) -> tuple[int, int, int]:
    """(widest gap, channels over 1 step, channels) of two (H, W, 4)
    uint8 frames' RGB channels."""
    if frame.shape != ref.shape:
        raise ValueError(f"check: frame {frame.shape} vs reference "
                         f"{ref.shape}")
    d = np.abs(frame[..., :3].astype(np.int16) - ref[..., :3])
    return int(d.max()), int((d > 1).sum()), int(d.size)


class Tally:
    def __init__(self):
        self.widest, self.over, self.total, self.frames = 0, 0, 0, 0

    def add(self, frame, ref, label=""):
        w, o, n = gaps(frame, ref)
        self.widest = max(self.widest, w)
        self.over += o
        self.total += n
        self.frames += 1
        print(f"check {label}: widest gap {w}, {o} of {n} channels over 1",
              file=sys.stderr, flush=True)

    def merge(self, other: dict):
        self.widest = max(self.widest, other["widest"])
        self.over += other["over"]
        self.total += other["total"]
        self.frames += other["frames"]

    def state(self) -> dict:
        return dict(widest=self.widest, over=self.over, total=self.total,
                    frames=self.frames)

    def numbers(self) -> dict:
        return {"max_gap_lsb": self.widest,
                "share_over_1_lsb": self.over / max(self.total, 1)}


def judge(numbers: dict, limits: dict, frames: int):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, over at least one compared frame."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = frames > 0 and all(c["value"] <= c["limit"]
                            for c in checks.values())
    return ok, checks


def report(checks: dict, frames: int) -> None:
    """The numbers beside their limits, as the last lines on stderr."""
    print(f"check: {frames} frames compared", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
