"""The port's multi-view renderer (mo_renderer_tpu_torch/parallel/
multi_view.py) on two gloo CPU ranks, one process each.

One spawn of a world of two, 128x32 frames of the tiny scene.  Bars, the
reference's own:

- three views (an odd count: padded to four, rank r renders views 2r and
  2r + 1) equal single-view ``Renderer`` frames bit for bit
  (tests/test_parallel.py:159-170);
- a 3-step x 2-view camera path (``render_view_sequence_device``) equals
  per-step ``render_views_device`` bit for bit on each rank
  (tests/test_parallel.py:131-155);
- a spawned cube shows in the next views
  (tests/test_incremental_prepare.py:163);
- a bin overflow on one rank's views raises on both ranks.

No JAX frame is compiled here: the JAX multi-view frame equals the JAX
single-view frame bit for bit (tests/test_parallel.py), and the port's
single-view frame is held to the JAX one (tests/test_torch_frame.py), so
the port's views are held to the same bar through their own single-view
frames.  The ranks import torch only.  One more test, in this process on
a world of one, holds two views at the default pose of the 256x128 tiny
config directly to the JAX package's stored frame there
(tests/golden/entry_cb_256x128.png) under the golden bar of
tests/test_golden.py:99-107.
"""

import multiprocessing
import os
import socket
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mo_renderer_tpu_torch import Renderer, scenes  # noqa: E402

N_RANKS = 2
ANGLES = (0.0, 1.0, 2.0)


def _config(**overrides):
    return scenes.tiny_config(width=128, height=32, **overrides)


def _sky_camera(cfg):
    """A camera 500 units out, looking away from the scene: sky only."""
    from mo_renderer_tpu_torch.math import quat
    from mo_renderer_tpu_torch.scene.camera import Camera

    cam = Camera(position=(0.0, 1.0, 500.0), rotation=quat.from_rotation_y(0.0))
    cam.resize((cfg.width, cfg.height))
    return cam


def _rank_main(rank, init_method, out_dir):
    """One rank: views, a camera path, a spawn and an overflow, each
    result saved for the parent."""
    import torch
    import torch.distributed as dist

    from mo_renderer_tpu_torch.assets.procedural import procedural_model
    from mo_renderer_tpu_torch.math.transform import Transform
    from mo_renderer_tpu_torch.parallel import (
        MultiViewRenderer,
        make_rank_group,
    )
    from mo_renderer_tpu_torch.passes.frame_graph import build_camera_params
    from mo_renderer_tpu_torch.scene.scene_buffers import find_shadow_light

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=N_RANKS, rank=rank)
    try:
        group = make_rank_group()
        cfg = _config()
        world = scenes.tiny_world()
        world.insert_resource(scenes.camera(cfg))
        mv = MultiViewRenderer(cfg, group, device="cpu")
        mv.prepare(world)
        out = {"views": mv.render_views(
            [scenes.camera(cfg, a) for a in ANGLES], world)}

        light_pv, _ = find_shadow_light(world)
        rigs = [[scenes.camera(cfg, 0.4 * s + 1.5 * i) for i in range(2)]
                for s in range(3)]
        steps = [[build_camera_params(c, light_pv, "cpu") for c in rig]
                 for rig in rigs]
        seq = mv.render_view_sequence_device(steps, world)
        out["seq"] = seq.numpy()
        out["seq_equal"] = np.array([
            torch.equal(seq[s], mv.render_views_device(rigs[s], world))
            for s in range(3)])
        mv.check_overflow()

        cam = scenes.camera(cfg)
        out["before_spawn"] = mv.render_views([cam, cam], world)
        world.spawn((Transform.from_xyz(0.0, 0.5, 0.0),
                     procedural_model("cube", base_color=(1, 0, 0, 1))))
        out["after_spawn"] = mv.render_views([cam, cam], world)

        # rank 0 sees only sky (no pairs), rank 1 the scene: past a cap of
        # 8 pairs only rank 1 drops geometry, and both ranks raise
        small = MultiViewRenderer(
            _config(binned_cap=8, shadow_enabled=False), group, "cpu")
        small.prepare(world)
        try:
            small.render_views([_sky_camera(cfg), cam], world)
            out["raised"] = np.array("")
        except RuntimeError as e:
            out["raised"] = np.array(str(e))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("multi_view")
    ctx = multiprocessing.get_context("spawn")
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(r, init, str(out)))
             for r in range(N_RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * N_RANKS
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(N_RANKS)]


def test_views_equal_single_view_frames(ranks):
    """An odd view count is padded; every rank holds all three views."""
    for r in ranks:
        assert r["views"].shape == (3, 32, 128, 4)
        np.testing.assert_array_equal(r["views"], ranks[0]["views"])
    cfg = _config()
    world = scenes.tiny_world()
    world.insert_resource(scenes.camera(cfg))
    single = Renderer(cfg, "cpu")
    single.prepare(world)
    for i, a in enumerate(ANGLES):
        world.insert_resource(scenes.camera(cfg, a))
        np.testing.assert_array_equal(ranks[0]["views"][i],
                                      single.render(world), err_msg=f"{i}")
    assert not np.array_equal(ranks[0]["views"][0], ranks[0]["views"][1])


def test_view_sequence_equals_per_step_views(ranks):
    for r in ranks:
        assert r["seq"].shape == (3, 1, 32, 128)
        assert r["seq_equal"].all()
    # the two ranks rendered different views
    assert not np.array_equal(ranks[0]["seq"], ranks[1]["seq"])


def test_spawn_is_seen_in_the_next_views(ranks):
    for r in ranks:
        assert not np.array_equal(r["before_spawn"], r["after_spawn"])
        np.testing.assert_array_equal(r["after_spawn"],
                                      ranks[0]["after_spawn"])


def test_overflow_raises_on_every_rank(ranks):
    for r in ranks:
        assert "bin overflow" in str(r["raised"]), str(r["raised"])


def test_world_of_one_views_hold_the_reference_golden():
    """Views at the golden's pose hold the JAX frame's bar (mean |diff| <
    2/255, fewer than 0.5% of channels above 16/255), with no JAX
    compile: the reference's stored frame at that pose."""
    import torch.distributed as dist
    from PIL import Image

    from mo_renderer_tpu_torch.parallel import (
        MultiViewRenderer,
        make_rank_group,
    )

    golden = np.asarray(Image.open(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "golden",
        "entry_cb_256x128.png")).convert("RGBA")).astype(np.int32)
    cfg = scenes.tiny_config()
    world = scenes.tiny_world()
    cam = scenes.camera(cfg)
    world.insert_resource(cam)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mv = MultiViewRenderer(cfg, make_rank_group(), device="cpu")
        mv.prepare(world)
        views = mv.render_views([cam, cam], world)
    finally:
        dist.destroy_process_group()
    assert views.shape == (2,) + golden.shape
    for v in views:
        diff = np.abs(v.astype(np.int32) - golden)[..., :3]
        assert diff.mean() < 2.0 and (diff > 16).mean() < 0.005, (
            diff.mean(), (diff > 16).mean())
