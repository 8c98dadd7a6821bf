"""A uniform sample of a stream of unknown length, drawn from the seed
(reservoir sampling, algorithm R)."""

from __future__ import annotations

import numpy as np


class Reservoir:
    def __init__(self, k: int, seed):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.n = 0
        self.items = []

    def offer(self, key, make):
        """Consider item ``key``; ``make()`` gives its value when kept."""
        if self.n < self.k:
            self.items.append((key, make()))
        else:
            j = int(self.rng.integers(0, self.n + 1))
            if j < self.k:
                self.items[j] = (key, make())
        self.n += 1
