"""The port's default fast frame against the JAX frame from a view with no
sky: the tiny scene at 256x128 seen from ``scenes.TINY_LIT_VIEW``, over
its 8-unit plane, so that every pixel is shaded as geometry (the other
frame tests all look at the sky over a part of the frame).  Each side
builds the scene and the camera with its own package, from the same
numbers.

Bar: the golden bar of tests/test_golden.py:99-107 (mean |diff| < 2/255,
fewer than 0.5% of channels above 16/255).  One JAX frame.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402,F401  (the JAX package's frame below)
import numpy as np  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mo_renderer_tpu.math import quat as jquat  # noqa: E402
from mo_renderer_tpu.passes.frame_graph import (  # noqa: E402
    Renderer as JRenderer,
)
from mo_renderer_tpu.scene.camera import Camera as JCamera  # noqa: E402
from mo_renderer_tpu_torch import Renderer, scenes  # noqa: E402
from mo_renderer_tpu_torch.passes import frame_graph as FG  # noqa: E402


def _jax_lit_camera(cfg):
    """scenes.tiny_lit_camera, built with the JAX package's Camera."""
    v = scenes.TINY_LIT_VIEW
    d = np.array([np.sin(v["yaw"]), 0.0, np.cos(v["yaw"])])
    cam = JCamera(
        position=tuple(-v["back"] * d + np.array([0.0, v["height"], 0.0])),
        rotation=jquat.mul(jquat.from_rotation_y(v["yaw"]),
                           jquat.from_rotation_x(v["pitch"])))
    cam.resize((cfg.width, cfg.height))
    return cam


def test_sky_free_frame_matches_reference(monkeypatch):
    """Every pixel of the port's G-buffer is geometry (depth < 1), and the
    frame holds the golden bar against the JAX frame."""
    cfg = scenes.tiny_config()
    world = scenes.tiny_world()
    world.insert_resource(scenes.tiny_lit_camera(cfg))
    depths = []
    shade = FG.shading_pass_fast

    def record(gbuf, *args, **kwargs):
        depths.append(gbuf.depth)
        return shade(gbuf, *args, **kwargs)

    monkeypatch.setattr(FG, "shading_pass_fast", record)
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    frame = np.asarray(r.render(world)).astype(np.int32)
    assert len(depths) == 1
    assert int((depths[0] >= 1.0).sum()) == 0

    jcfg = graft._tiny_config()
    jworld = graft._tiny_world()
    jworld.insert_resource(_jax_lit_camera(jcfg))
    jr = JRenderer(jcfg)
    jr.prepare(jworld)
    ref = np.asarray(jr.render(jworld)).astype(np.int32)
    assert frame.shape == ref.shape == (128, 256, 4)
    diff = np.abs(frame - ref)[..., :3]
    print(f"sky-free frame vs JAX frame: max |diff| {diff.max()} LSB, mean "
          f"{diff.mean():.4f}, {(diff > 16).mean():.4%} > 16")
    assert diff.mean() < 2.0, f"mean |diff| {diff.mean():.3f}"
    assert (diff > 16).mean() < 0.005
