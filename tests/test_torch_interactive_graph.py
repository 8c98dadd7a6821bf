"""What the captured interactive frame hangs on, checked on the CPU
(mo_renderer_tpu_torch/passes/frame_graph.py, parallel/tile_sharding.py).

On a card ``Renderer.render_device`` and ``TileShardedRenderer.render_device``
replay a CUDA graph keyed on the layout (``Renderer._graph_key``), whose
inputs are buffers it owns (``_StagedScene``); on the CPU the frame runs
eagerly.  The replay itself is checked on the card (``chip_smoke.py``
``[3] interactive``, ``tests/test_torch_cuda.py``); here:

- the key stays the same over what an interactive frame meets every
  frame (a camera, entity or light move, a spawn, a despawn) and changes
  where the frame's shapes or program change (a resize, a full prepare, a
  light that stops casting, an extra pass, the shadow memoized or
  rastered in the frame), as ``jax.jit`` keys its program on shapes and
  static arguments;
- the staged fields are exactly the fields those updates replace, by
  tensor identity, and staging follows a field that is written in place;
- band binning with no host read (``bin_triangles(band_row0=...)``)
  lists the whole frame's runs in its rows under the capacity, and past
  it the head of each of those runs, dropping its own pairs past the
  capacity;
- the row-sharded frame equals the single-device frame bit for bit on a
  gloo world of one, counts its dropped pairs alike (summed over the
  bands on the device), and needs no ``all_reduce``;
- ``chip_smoke.py``'s check of a replayed call's profiles accepts an
  earlier profile only where it lacks exactly one replay's hand kernels.

No JAX frame: 128x32 and 128x64 frames of the tiny scene.
"""

import dataclasses
import functools
import os
import socket
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mo_renderer_tpu_torch import Renderer, RenderPass, scenes  # noqa: E402
from mo_renderer_tpu_torch.assets.model import Model  # noqa: E402
from mo_renderer_tpu_torch.assets.procedural import procedural_model  # noqa: E402
from mo_renderer_tpu_torch.kernels import raster_setup as RS  # noqa: E402
from mo_renderer_tpu_torch.kernels.rasterizer import BIN_H, BIN_W  # noqa: E402
from mo_renderer_tpu_torch.math.transform import Transform  # noqa: E402
from mo_renderer_tpu_torch.passes import frame_graph as FG  # noqa: E402
from mo_renderer_tpu_torch.scene.camera import Camera  # noqa: E402
from mo_renderer_tpu_torch.scene.components import DirectionalLight  # noqa: E402
from mo_renderer_tpu_torch.scene.scene_buffers import (  # noqa: E402
    incremental_repack,
    refresh_tri_attrs,
    refresh_transforms,
)


def _cube(x):
    return (Transform.from_xyz(x, 0.3, 0.9),
            procedural_model("cube", base_color=(0.2, 0.9, 0.2, 1.0)))


@functools.lru_cache(maxsize=1)
def _ibl():
    """One computed IBL for the module (its precompute is most of a CPU
    prepare)."""
    return scenes.tiny_ibl()


def _world(cfg):
    world = scenes.tiny_world()
    world.insert_resource(_ibl())
    world.insert_resource(scenes.camera(cfg))
    return world


def _setup(width=128, height=32, **overrides):
    cfg = scenes.tiny_config(width=width, height=height, **overrides)
    world = _world(cfg)
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    return r, world


def _key(r, world):
    """One eager frame, then the key its captured form would have."""
    r.render_device(world)
    params, has_light = r.frame_params(world)
    quads = r._cached_shadow_quads(params.host_field("light_proj_view"),
                                   params["light_proj_view"], has_light)
    return r._graph_key(has_light, quads)


def _light(world):
    return next(lt for lt in world.query(DirectionalLight)
                if lt.is_shadow_caster)


def _move_entity(world, dx=0.25):
    transform = next(iter(world.query(Transform, Model)))[0]
    transform.translation = (np.asarray(transform.translation)
                             + np.float32([dx, 0.0, 0.0])).astype(np.float32)


def _move_camera(world):
    camera = world.resource(Camera)
    camera.transform.translation = (np.asarray(camera.transform.translation)
                                    + np.float32([0.1, 0.0, 0.0]))
    camera.refresh_view()


def _spawn(world):
    world._test_cube = world.spawn(_cube(0.6))


def _move_light(world):
    _light(world).shadow_width += 0.5


UPDATES = {
    "camera move": _move_camera,
    "entity move": _move_entity,
    "spawn": _spawn,
    "despawn": lambda world: world.despawn(world._test_cube),
    "light move": _move_light,
}


@pytest.mark.parametrize("update", list(UPDATES))
def test_layout_key_survives_frame_updates(update):
    r, world = _setup()
    if update == "despawn":
        _spawn(world)  # a frame with the cube, then the despawn
    key = _key(r, world)
    quads = r._shadow_quads
    UPDATES[update](world)
    assert _key(r, world) == key
    assert r._prepare_count == 1, "the update ran a full prepare"
    if update == "camera move":
        assert r._shadow_quads is quads
    else:  # the memo recomputed (a new light or scene), the key stays
        assert r._shadow_quads is not quads


def _resize(r, world):
    r.resize(160, 64)


def _prepare(r, world):
    r.prepare(world)


def _light_off(r, world):
    _light(world).is_shadow_caster = False


def _extra_pass(r, world):
    r.extra_passes.append(RenderPass())


@pytest.mark.parametrize("change", ["resize", "prepare", "has_light",
                                    "extra pass", "shadow mode"])
def test_layout_key_changes_with_the_program(change):
    r, world = _setup()
    key = _key(r, world)
    if change == "shadow mode":
        # the same frame with the shadow rastered in the graph (a camera
        # path whose light moves per step) is another program
        _, has_light = r.frame_params(world)
        assert r._graph_key(has_light, None) != key
        return
    {"resize": _resize, "prepare": _prepare, "has_light": _light_off,
     "extra pass": _extra_pass}[change](r, world)
    assert _key(r, world) != key


def _replaced(before, after):
    return {f.name for f in dataclasses.fields(before)
            if getattr(before, f.name) is not getattr(after, f.name)}


def test_staged_fields_are_the_fields_updates_replace():
    """Every frame-to-frame update of a SceneBuffers replaces only staged
    fields, and together they replace every staged field: a new update
    that replaces another field fails here (a graph would read the stale
    tensor), and so does a staged field nothing replaces any more."""
    r, world = _setup()
    cfg = r.config
    seen = {}
    scene = r.scene
    _move_entity(world)
    moved = refresh_transforms(scene)
    seen["refresh_transforms"] = _replaced(scene, moved)
    entity = world.spawn(_cube(0.6))
    spawned = incremental_repack(moved, world, cfg, forbid_uv1=True)
    assert spawned is not None
    seen["spawn"] = _replaced(moved, spawned)
    world.despawn(entity)
    despawned = incremental_repack(spawned, world, cfg, forbid_uv1=True)
    assert despawned is not None
    seen["despawn"] = _replaced(spawned, despawned)
    seen["refresh_tri_attrs"] = _replaced(despawned,
                                          refresh_tri_attrs(despawned))
    assert seen["refresh_transforms"] == {"mesh_world", "mesh_normal_mat",
                                          "tri_attrs"}
    assert seen["spawn"] == seen["refresh_tri_attrs"] == {"tri_attrs"}
    assert seen["despawn"] == set()
    assert set().union(*seen.values()) == set(FG.STAGED_FIELDS)


def test_staging_follows_replaced_and_rewritten_fields():
    """The staged scene copies a replaced field, and a field written in
    place since its last copy (a spawn writes mesh rows into the current
    ``mesh_world``); the other fields are the scene's own tensors, and
    replacing one of them without a prepare raises."""
    r, world = _setup()
    staged = FG._StagedScene(r._layout(), r.scene)

    def check(scene):
        staged.stage(scene)
        for name, t in FG._scene_fields(scene):
            got = getattr(staged.scene, name)
            if name in FG.STAGED_FIELDS:
                assert got is not t and torch.equal(got, t), name
            else:
                assert got is t, name

    _move_entity(world)
    r.scene = refresh_transforms(r.scene)
    check(r.scene)
    mesh_world = r.scene.mesh_world
    world.spawn(_cube(0.6))
    spawned = incremental_repack(r.scene, world, r.config, forbid_uv1=True)
    assert spawned.mesh_world is mesh_world  # rows written in place
    assert not torch.equal(staged.scene.mesh_world, mesh_world)
    check(spawned)
    with pytest.raises(RuntimeError, match="replaced without a prepare"):
        staged.stage(dataclasses.replace(
            spawned, tri_valid=spawned.tri_valid.clone()))


def _band_setups():
    """The 256x128 frame's and the 256^2 shadow map's setups of the tiny
    scene, each with the bands a world of two cuts it into."""
    r, world = _setup(width=256, height=128)
    params, _ = r.frame_params(world)
    s = r.config.shadow_map_size
    return r, [
        (RS.triangle_setup_from_attrs(r.scene.tri_attrs, r.scene.tri_valid,
                                      params["proj_view"], r.pad_w, r.pad_h),
         r.pad_w, r.pad_h),
        (RS.triangle_setup_from_attrs(r.scene.tri_attrs, r.scene.tri_valid,
                                      params["light_proj_view"], s, s,
                                      cull_backface=False), s, s),
    ]


def _runs(binned):
    """Each tile's run of triangle ids, as a list a tile."""
    start, count = binned.tile_start.tolist(), binned.tile_count.tolist()
    ids = binned.pair_tri.tolist()
    return [ids[s:s + c] for s, c in zip(start, count)]


@pytest.mark.parametrize("capacity", ["below", "past"])
def test_band_static_binning_equals_exact_band_binning(capacity):
    """A band's runs against the whole frame's runs in its rows (the
    whole frame binned under the capacity, every pair kept): equal while
    the band's pairs fit, and past the capacity the head of each, as many
    pairs as the capacity, the rest counted as dropped."""
    r, setups = _band_setups()
    for setup, w, h in setups:
        n_x, n_y = -(-w // BIN_W), h // BIN_H
        grid = dict(tile_h=BIN_H, tile_w=BIN_W, n_tiles_x=n_x,
                    n_tiles_y=n_y)
        whole = RS.bin_triangles(setup, binned_cap=r._binned_cap, **grid)
        assert int(whole.overflow) == 0
        whole_runs = _runs(whole)
        for row0, rows in ((0, n_y // 2), (n_y // 2, n_y - n_y // 2)):
            tiles = range(row0 * n_x, (row0 + rows) * n_x)
            total = sum(len(whole_runs[k]) for k in tiles)
            assert total > 0
            cap = r._binned_cap if capacity == "below" else total - 3
            band = RS.bin_triangles(setup, binned_cap=cap, band_row0=row0,
                                    band_tile_rows=rows, **grid)
            assert torch.is_tensor(band.overflow)
            assert int(band.overflow) == max(total - cap, 0)
            assert band.pair_tri.shape == (cap,)
            assert int(band.tile_count.sum()) == min(total, cap)
            assert torch.equal(band.bbox, whole.bbox)
            band_runs = _runs(band)
            for k, run in enumerate(band_runs):
                want = whole_runs[k] if k in tiles else []
                assert run == want[:len(run)]
                if capacity == "below":
                    assert run == want


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def world_of_one():
    import torch.distributed as dist

    from mo_renderer_tpu_torch.parallel import make_rank_group

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        yield make_rank_group(backend="gloo")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("binned_cap", [None, 64], ids=["fits", "past_cap"])
def test_rows_frame_static_equals_exact(world_of_one, monkeypatch,
                                        binned_cap):
    """The row-sharded frame on a world of one equals the single-device
    frame (its shadow rastered in the frame) bit for bit, while the pairs
    fit and past the capacity alike (both keep the first triangles'
    pairs), and counts the same dropped pairs (summed over the bands on
    the device); ``render_device`` makes no ``all_reduce``."""
    import torch.distributed as dist

    from mo_renderer_tpu_torch.parallel import TileShardedRenderer

    cfg = scenes.tiny_config(width=128, height=64, ssao_res_divisor=1,
                             binned_cap=binned_cap)
    world = _world(cfg)
    ts = TileShardedRenderer(cfg, world_of_one, device="cpu")
    ts.prepare(world)
    params, has_light = ts._inner.frame_params(world)
    static, s_counts = ts._frame(params, has_light)
    single = Renderer(cfg, "cpu")
    single.prepare(world)
    want, w_counts = single._frame(params, None, has_light)
    assert s_counts.dtype == torch.int64 and s_counts.shape == (2,)
    assert torch.equal(s_counts, w_counts) and torch.equal(static, want)
    if binned_cap is None:
        assert not s_counts.any()
    else:
        assert s_counts[0] > 0 and s_counts[1] > 0

    def no_all_reduce(*args, **kwargs):
        raise AssertionError("the sharded frame made an all_reduce")

    monkeypatch.setattr(dist, "all_reduce", no_all_reduce)
    frame = ts.render_device(world)
    pending = ts._inner._pending_overflow[-1]
    assert torch.is_tensor(pending) and torch.equal(pending, s_counts)
    if binned_cap is None:
        assert torch.equal(frame, static)
        ts.check_overflow()
    else:
        with pytest.raises(RuntimeError, match=f"{int(s_counts[0])} "
                           f"G-buffer and {int(s_counts[1])} shadow"):
            ts.check_overflow()


# a 2-step call's kernels as the profiler names them: two hand kernels and
# a torch op, each run once a replay
_FULL = {"void raster_kernel<0>(...)": 2, "shade_kernel(ShadeArgs)": 2,
         "void at::native::copy_kernel": 3}


@pytest.mark.parametrize("attempts, ok", [
    ([(7, 4, 4, _FULL)], True),
    ([(3, 2, 4, {"void raster_kernel<0>(...)": 1,
                 "shade_kernel(ShadeArgs)": 1,
                 "void at::native::copy_kernel": 2}),
      (7, 4, 4, _FULL)], True),
    ([(3, 2, 4, {"void raster_kernel<0>(...)": 2,
                 "void at::native::copy_kernel": 3}),
      (7, 4, 4, _FULL)], False),
    ([(0, 0, 4, {}), (7, 4, 4, _FULL)], False),
    ([(5, 2, 4, {"void raster_kernel<0>(...)": 1,
                 "shade_kernel(ShadeArgs)": 1,
                 "void at::native::copy_kernel": 4}),
      (7, 4, 4, _FULL)], False),
    ([(3, 2, 4, {"void raster_kernel<0>(...)": 1,
                 "shade_kernel(ShadeArgs)": 1,
                 "void at::native::copy_kernel": 1})] * 3, False),
], ids=["first", "one-replay-dropped", "one-kernel-dropped", "empty",
        "more-than-full", "never-full"])
def test_sequence_profile_check_accepts_only_a_dropped_replay(attempts, ok):
    """_check_short_profiles: the last profile must see every counted hand
    kernel; an earlier one may only lack one of the two replays' hand
    kernels, each name alike, and see nothing more than the last."""
    import chip_smoke

    if ok:
        chip_smoke._check_short_profiles("sequence", attempts)
    else:
        with pytest.raises(AssertionError):
            chip_smoke._check_short_profiles("sequence", attempts)
