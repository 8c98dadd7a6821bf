"""The port's row-sharded frame (mo_renderer_tpu_torch/parallel/
tile_sharding.py) on two gloo CPU ranks, one process each.

One spawn of a world of two renders a 256x256 frame with checkerboard
shading off and on (SSAO at full rate, as row sharding runs it).  Bars:

- against the port's single-device frame of the same config, the
  reference's seam bars (tests/test_parallel.py:88-93, 123-128, with
  n = 2 bands): mean |diff| < 0.05 LSB (cb off) / 0.08 (cb on), and the
  rows that differ at all are at most 2n / 4n;
- the cb-on frame within the golden bar of tests/test_golden.py:99-107
  (mean |diff| < 2/255, fewer than 0.5% of channels above 16/255) of the
  JAX TileShardedRenderer on two virtual CPU devices.

On a world of one, in this process, the sharded frame is the
single-device frame bit for bit.  jax is imported inside the test that
needs it, so the spawned ranks import only torch.
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
HEIGHT = 256
SEAM_BARS = {False: (0.05, 2 * N_RANKS), True: (0.08, 4 * N_RANKS)}


def _config(cb):
    return scenes.tiny_config(height=HEIGHT, checkerboard=cb,
                              ssao_res_divisor=1)


def _rank_main(rank, init_method, out_dir):
    """One rank: join the gloo world, render cb off and cb on, save both
    whole frames."""
    import torch
    import torch.distributed as dist

    from mo_renderer_tpu_torch.parallel import (
        TileShardedRenderer,
        make_rank_group,
    )

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=N_RANKS, rank=rank)
    try:
        group = make_rank_group()
        frames = {}
        for cb in (False, True):
            cfg = _config(cb)
            world = scenes.tiny_world()
            world.insert_resource(scenes.camera(cfg))
            ts = TileShardedRenderer(cfg, group, device="cpu")
            ts.prepare(world)
            frames[f"cb{int(cb)}"] = ts.render(world)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **frames)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def sharded_frames(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
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
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(N_RANKS)]
    for key, frame in ranks[0].items():
        # every rank holds the whole frame
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[key], frame)
    return {cb: ranks[0][f"cb{int(cb)}"] for cb in (False, True)}


def _diff(a, b):
    assert a.shape == b.shape == (HEIGHT, 256, 4)
    return np.abs(a.astype(np.int32) - b.astype(np.int32))[..., :3]


@pytest.mark.parametrize("cb", [False, True], ids=["cb_off", "cb_on"])
def test_sharded_frame_matches_single_device_but_seams(sharded_frames, cb):
    cfg = _config(cb)
    world = scenes.tiny_world()
    world.insert_resource(scenes.camera(cfg))
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    diff = _diff(sharded_frames[cb], r.render(world))
    bad_rows = np.unique(np.where(diff.max(axis=(1, 2)) > 0)[0])
    mean_bar, rows_bar = SEAM_BARS[cb]
    print(f"cb={cb}: mean |diff| {diff.mean():.4f}, max {diff.max()}, rows "
          f"that differ {bad_rows.tolist()}")
    assert diff.mean() < mean_bar
    assert len(bad_rows) <= rows_bar
    # only rows next to the band border may differ
    assert all(abs(int(y) - HEIGHT // N_RANKS) <= 2 for y in bad_rows)


def test_sharded_frame_matches_the_jax_sharded_frame(sharded_frames):
    import dataclasses

    import jax

    import __graft_entry__ as graft
    from mo_renderer_tpu.parallel import TileShardedRenderer as JSharded
    from mo_renderer_tpu.parallel import make_view_mesh

    cfg = dataclasses.replace(graft._tiny_config(), height=HEIGHT,
                              checkerboard=True, ssao_res_divisor=1)
    world = graft._tiny_world()
    world.insert_resource(graft._camera(cfg))
    ts = JSharded(cfg, make_view_mesh(jax.devices()[:N_RANKS],
                                      axis_name="rows"))
    ts.prepare(world)
    diff = _diff(sharded_frames[True], np.asarray(ts.render(world)))
    print(f"vs JAX sharded frame: max |diff| {diff.max()} LSB, mean "
          f"{diff.mean():.4f}, {(diff > 16).mean():.4%} > 16")
    assert diff.mean() < 2.0 and (diff > 16).mean() < 0.005


@pytest.mark.parametrize("overrides,name", [
    ({"ssao_res_divisor": 2}, "ssao_res_divisor"),
    ({"ssao_pallas": False}, "ssao_pallas"),
    ({"fast_sampling": False}, "fast_sampling"),
    ({"raster_interp_attrs": True, "ssao_res_divisor": 1},
     "raster_interp_attrs"),
])
def test_unsupported_options_raise(overrides, name):
    """The row-sharded frame raises on what it does not run, naming the
    option, before it touches the process group."""
    from mo_renderer_tpu_torch.parallel import RankGroup, TileShardedRenderer

    cfg = scenes.tiny_config(**{"ssao_res_divisor": 1, **overrides})
    with pytest.raises(ValueError, match=name):
        TileShardedRenderer(cfg, RankGroup(group=None, rank=0, size=1),
                            device="cpu")


def test_uv1_scene_raises_at_prepare():
    """A scene that samples UV set 1 takes the reference sampling path,
    which row sharding does not run."""
    from mo_renderer_tpu_torch.parallel import RankGroup, TileShardedRenderer

    cfg = _config(True)
    world = scenes.tiny_world(uv1=True)
    world.insert_resource(scenes.camera(cfg))
    ts = TileShardedRenderer(cfg, RankGroup(group=None, rank=0, size=1),
                             device="cpu")
    with pytest.raises(ValueError, match="UV set 1"):
        ts.prepare(world)


def test_world_of_one_is_the_single_device_frame():
    """On a world of one the band is the whole frame: the sharded frame
    equals the single-device frame bit for bit.  A 200^2 shadow map does
    not split into whole bin rows, so the map is rastered whole."""
    import torch.distributed as dist

    from mo_renderer_tpu_torch.parallel import (
        TileShardedRenderer,
        make_rank_group,
        tile_sharding,
    )

    cfg = scenes.tiny_config(shadow_map_size=200, ssao_res_divisor=1)
    assert not tile_sharding.shadow_bands_divisible(cfg, 1)
    world = scenes.tiny_world()
    world.insert_resource(scenes.camera(cfg))
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    want = r.render(world)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        ts = TileShardedRenderer(cfg, make_rank_group(), device="cpu")
        ts.prepare(world)
        np.testing.assert_array_equal(ts.render(world), want)
    finally:
        dist.destroy_process_group()


def test_spawn_keeps_the_band_program():
    """A spawn shows in the sharded frame (on a world of one, the
    single-device frame of a fresh prepare, bit for bit), and the
    incremental repack keeps the band program: the rebuild keys on the
    inner Renderer's ``_prepare_count``.  A spawn the layout cannot absorb
    (new texture content) re-prepares and rebuilds it."""
    import torch.distributed as dist

    from mo_renderer_tpu_torch.assets.procedural import procedural_model
    from mo_renderer_tpu_torch.math.transform import Transform
    from mo_renderer_tpu_torch.parallel import (
        TileShardedRenderer,
        make_rank_group,
    )
    from mo_renderer_tpu_torch.scene.components import DirectionalLight
    from mo_renderer_tpu_torch.scene.world import World

    cfg = scenes.tiny_config(width=128, height=64, ssao_res_divisor=1)
    world = World()  # no IBL: the sky is black, the geometry is lit
    world.spawn((Transform.from_xyz(0.0, -0.5, 0.0),
                 procedural_model("plane", size=8.0)))
    world.spawn((DirectionalLight(
        Transform.from_xyz(5.0, 8.0, 5.0).looking_at((0.0, 0.0, 0.0)),
        (1.0, 1.0, 1.0), 4.0, True,
    ),))
    world.insert_resource(scenes.camera(cfg))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        ts = TileShardedRenderer(cfg, make_rank_group(backend="gloo"),
                                 device="cpu")
        ts.prepare(world)
        f0 = ts.render(world)
        program = ts._frame_fn

        world.spawn((Transform.from_xyz(0.0, 0.5, 0.0),
                     procedural_model("cube", base_color=(1, 0, 0, 1))))
        f1 = ts.render(world)
        assert not np.array_equal(f0, f1), "spawn not visible"
        assert ts._inner._prepare_count == 1
        assert ts._frame_fn is program, "incremental repack rebuilt"
        r = Renderer(cfg, "cpu")
        r.prepare(world)
        np.testing.assert_array_equal(f1, r.render(world))

        world.spawn((Transform.from_xyz(1.0, 0.5, 0.0),
                     procedural_model("cube", textured=True)))
        ts.render(world)
        assert ts._inner._prepare_count == 2
        assert ts._frame_fn is not program
    finally:
        dist.destroy_process_group()
