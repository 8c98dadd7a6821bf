"""The control on the card: the plain reference in the program's place,
its float32 products in TF32, fails the check of each one-card cell on
three seeds (one sampled frame each here; ``harness.control`` reads the
cell's own sample)."""

import json
import os

import pytest

from benchmark.harness import control
from benchmark.harness.main import make_run

from .conftest import REPO

CELLS = [w["name"] for w in json.load(
    open(os.path.join(REPO, "BENCHMARK.json")))["workloads"]
    if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_fails_the_check(cuda, cell):
    for seed in (101, 202, 303):
        run = make_run(REPO, ["--workload", cell, "--seed", str(seed),
                              "--seconds", "1"], device=cuda)
        assert control.readings(run, 1)["passes_limits"] is False
