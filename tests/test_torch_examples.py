"""The port's copies of the reference's four examples
(mo_renderer_tpu_torch/examples/) against examples/*.py, on the CPU.

- ``sponza_scale.build_app(n_grid=3)`` at 128x64 against the JAX
  ``examples.sponza_scale.build_app(n_grid=3)``, each lit by the tiny
  synthetic sky of its own package inserted before ``resumed()``: one
  frame within the golden bar of tests/test_golden.py:99-107 (mean |diff|
  < 2/255, fewer than 0.5% of channels above 16/255).  The only JAX frame
  of this file.
- ``scenes.grid_world(10)`` is the example's scene: 51,802 triangles and
  every packed field equal to a pack of ``build_app(n_grid=10)``'s world.
- ``dynamic_spawn.main``: 6 spawns and their despawn give the pre-spawn
  frame back bit for bit, without a full prepare (128x64, n_grid=2).
- ``multi_view_flythrough``'s ``scripted_input`` and ``camera_rig`` give
  the reference's cameras on 40 steps of the path (numpy only).
- ``pbr_ibl.build_app`` renders a lit, non-black frame with the glTF
  loader replaced by a procedural sphere (the repository ships no
  ``man.glb``).
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402,F401
import numpy as np  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from examples import multi_view_flythrough as j_mv  # noqa: E402
from examples import sponza_scale as j_sponza  # noqa: E402
from mo_renderer_tpu import Camera as JCamera  # noqa: E402
from mo_renderer_tpu import Input as JInput  # noqa: E402
from mo_renderer_tpu import Timer as JTimer  # noqa: E402
from mo_renderer_tpu.scene.world import World as JWorld  # noqa: E402
from mo_renderer_tpu_torch import Camera, Input, Model, Timer, scenes  # noqa: E402
from mo_renderer_tpu_torch.assets.procedural import procedural_model  # noqa: E402
from mo_renderer_tpu_torch.examples import (  # noqa: E402
    dynamic_spawn,
    multi_view_flythrough,
    pbr_ibl,
    sponza_scale,
)
from mo_renderer_tpu_torch.scene.scene_buffers import pack_scene  # noqa: E402
from mo_renderer_tpu_torch.scene.world import World  # noqa: E402


def _golden_bar(frame, ref, what):
    diff = np.abs(frame.astype(np.int32) - ref.astype(np.int32))[..., :3]
    print(f"{what}: max |diff| {diff.max()} LSB, mean {diff.mean():.4f}, "
          f"{(diff > 16).mean():.4%} > 16")
    assert diff.mean() < 2.0 and (diff > 16).mean() < 0.005


def test_sponza_scale_frame_matches_jax():
    jcfg = dataclasses.replace(graft._tiny_config(), width=128, height=64)
    japp = j_sponza.build_app(jcfg, n_grid=3)
    japp.insert_resource(graft._tiny_ibl())
    japp.resumed()
    ref = np.asarray(japp.renderer.render(japp.world))

    cfg = scenes.tiny_config(width=128, height=64)
    app = sponza_scale.build_app(cfg, n_grid=3, device="cpu",
                                 ibl=scenes.tiny_ibl())
    app.resumed()
    frame = app.renderer.render(app.world)
    assert frame.shape == ref.shape == (64, 128, 4)
    assert int(app.renderer.scene.tri_valid.sum()) == int(
        np.asarray(japp.renderer.scene.tri_valid).sum()) == 4 * 1024 + 5 * 12 + 2
    _golden_bar(frame, ref, "sponza_scale n_grid=3")


def test_grid_world_is_the_examples_scene():
    cfg = scenes.tiny_config()
    grid = pack_scene(scenes.grid_world(10), cfg, "cpu")
    app = sponza_scale.build_app(cfg, n_grid=10, device="cpu",
                                 ibl=scenes.tiny_ibl())
    example = pack_scene(app.world, cfg, "cpu")
    assert int(grid.tri_valid.sum()) == 51_802
    for f in dataclasses.fields(grid):
        assert torch.equal(getattr(grid, f.name), getattr(example, f.name)), \
            f.name
    cam, ref_cam = scenes.grid_camera(cfg), sponza_scale.scene_camera()
    ref_cam.resize((cfg.width, cfg.height))
    np.testing.assert_array_equal(cam.view(), ref_cam.view())


def test_dynamic_spawn_restores_the_frame(monkeypatch, tmp_path):
    monkeypatch.setenv("MO_WIDTH", "128")
    monkeypatch.setenv("MO_HEIGHT", "64")
    monkeypatch.setenv("MO_OUT", str(tmp_path / "spawn.png"))
    res = dynamic_spawn.main(device="cpu", n_grid=2, ibl=scenes.tiny_ibl())
    assert res["bit_exact"] and res["prepares"] == 1
    assert os.path.getsize(tmp_path / "spawn.png") > 0


def _path_cameras(camera_cls, input_cls, timer_cls, world, mv, n_steps=40):
    world.insert_resource(input_cls())
    timer = timer_cls()
    timer.fixed_step = 1.0 / 60.0
    world.insert_resource(timer)
    world.insert_resource(camera_cls(
        position=(-3.0, 1.0, 3.0), rotation=(0.0, 0.38268343, 0.0, 0.9238795)))
    out = []
    for step in range(n_steps):
        mv.scripted_input(world.resource(input_cls), step)
        timer_cls.update_timer(world)
        camera_cls.update_camera(world)
        for cam in mv.camera_rig(world.resource(camera_cls), 8):
            out.append((np.asarray(cam.transform.translation),
                        np.asarray(cam.transform.rotation), cam.view()))
    return out


def test_scripted_input_and_camera_rig_match_reference():
    port = _path_cameras(Camera, Input, Timer, World(), multi_view_flythrough)
    ref = _path_cameras(JCamera, JInput, JTimer, JWorld(), j_mv)
    assert len(port) == len(ref) == 40 * 8
    assert not np.allclose(port[0][2], port[-1][2])  # the camera moved
    for (t, q, v), (t_r, q_r, v_r) in zip(port, ref):
        np.testing.assert_array_equal(t, t_r)
        np.testing.assert_array_equal(q, q_r)
        np.testing.assert_array_equal(v, v_r)


def test_pbr_ibl_renders_with_a_procedural_model(monkeypatch):
    loaded = []

    def load_gltf(path, resource_root=None):
        loaded.append(path)
        return procedural_model("sphere", base_color=(0.9, 0.6, 0.3, 1.0),
                                metallic=1.0, roughness=0.3)

    monkeypatch.setattr(Model, "load_gltf", staticmethod(load_gltf))
    cfg = scenes.tiny_config(width=128, height=32)
    app = pbr_ibl.build_app(cfg, device="cpu")
    app.insert_resource(scenes.tiny_ibl())
    frame = app.run(num_frames=1)
    assert loaded == ["man.glb"]
    assert frame.shape == (32, 128, 4) and frame[..., :3].max() > 0
    # the sphere in the middle is lit, not only the sky behind it
    assert len(np.unique(frame[12:20, 60:68, :3].reshape(-1, 3), axis=0)) > 1
