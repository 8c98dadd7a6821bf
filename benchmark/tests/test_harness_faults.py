"""The check against a broken timed path: each fault a cell can have,
planted under a run on the CPU, turns ``correct`` false; the sound path
stays true.  (The exchange between cards is not among them: the views
of a rank never leave it, and its one collective, the overflow
``all_reduce``, changes no frame.)"""

import json

import pytest
import torch

import mo_renderer_tpu_torch.passes.frame_graph as FG
from mo_renderer_tpu_torch.parallel import multi_view as MV

from benchmark.harness import main

from .conftest import tiny_root


def run(root, cell, capsys):
    rc = main.main(["--workload", cell, "--seed", "2147483659",
                    "--seconds", "0.6", "--trace", "0"], root=root,
                   device="cpu")
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def roots(tmp_path):
    return tiny_root(tmp_path, [
        ("t.walk", ("sponza_1080p", {}), "walk"),
        ("t.path", ("multi_view_4k", {"views": 4, "steps_per_call": 2,
                                      "check": {"frames": 6, "limits": {
                                          "max_gap_lsb": 8,
                                          "share_over_1_lsb": 0.001}}}),
         "path")])


def test_sound_runs_are_correct(roots, capsys):
    assert run(roots, "t.walk", capsys)["correct"] is True
    assert run(roots, "t.path", capsys)["correct"] is True


def test_a_frame_left_unchanged_is_caught(roots, capsys, monkeypatch):
    """Renderer.render hands back its first frame again and again."""
    orig = FG.Renderer.render
    kept = {}

    def stale(self, world):
        frame = orig(self, world)
        return kept.setdefault("frame", frame)
    monkeypatch.setattr(FG.Renderer, "render", stale)
    assert run(roots, "t.walk", capsys)["correct"] is False


def test_half_the_views_left_out_is_caught(roots, capsys, monkeypatch):
    """The second half of each step's views is never rendered."""
    orig = MV.MultiViewRenderer.render_view_sequence_device

    def half(self, steps, world):
        frames = orig(self, steps, world)
        frames[:, frames.shape[1] // 2:] = 0
        return frames
    monkeypatch.setattr(MV.MultiViewRenderer,
                        "render_view_sequence_device", half)
    assert run(roots, "t.path", capsys)["correct"] is False


@pytest.mark.parametrize("cell", ["t.walk", "t.path"])
def test_an_altered_pixel_is_caught(roots, capsys, monkeypatch, cell):
    """One pixel of every frame altered where the frame is produced."""
    orig = FG.frame_program

    def altered(*args, **kwargs):
        rgba, overflow = orig(*args, **kwargs)
        rgba = rgba.clone()
        rgba[3, 5] = rgba[3, 5] ^ torch.tensor(0x404040, dtype=torch.int32)
        return rgba, overflow
    monkeypatch.setattr(FG, "frame_program", altered)
    assert run(roots, cell, capsys)["correct"] is False
