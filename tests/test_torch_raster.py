"""The port's triangle setup, exact binning and tile rasterizer
(mo_renderer_tpu_torch/kernels/{raster_setup,rasterizer}.py) against the
JAX reference on the same inputs.  The JAX rasterizer runs its Pallas
kernel in interpret mode on the CPU, as its own tests do.

Bar (tests/test_rasterizer.py:138-139): triangle ids exactly equal,
depth within atol 1e-6.  Both rasterizers get the SAME setup rows (the
JAX setup's, as numpy), so the comparison isolates binning + raster; the
port's own setup is held to the reference's rows separately, at float
tolerance (XLA fuses multiply-adds on the CPU, PyTorch does not).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mo_renderer_tpu.kernels import raster_setup as JRS  # noqa: E402
from mo_renderer_tpu.kernels.rasterizer import rasterize as j_rasterize  # noqa: E402
from mo_renderer_tpu.kernels.rasterizer import (  # noqa: E402
    rasterize_attrs as j_rasterize_attrs,
)
from mo_renderer_tpu.passes import vertex_stage as JV  # noqa: E402
from mo_renderer_tpu.passes.frame_graph import (  # noqa: E402
    Renderer as JRenderer,
    build_camera_params as j_camera_params,
)
from mo_renderer_tpu.scene.scene_buffers import find_shadow_light  # noqa: E402
from mo_renderer_tpu_torch.kernels import raster_setup as RS  # noqa: E402
from mo_renderer_tpu_torch.kernels import rasterizer as R  # noqa: E402
from mo_renderer_tpu_torch.passes import vertex_stage as V  # noqa: E402

W, H = 256, 64


def _port_bins(setup, width, height, tile_h=R.BIN_H, tile_w=R.BIN_W,
               binned_cap=None):
    """The port's bins of ``setup`` over a ``width`` x ``height`` target,
    under ``binned_cap`` (default: the reference's pair capacity)."""
    nx, ny = -(-width // tile_w), -(-height // tile_h)
    if binned_cap is None:
        binned_cap = RS.pair_capacity(setup.bbox.shape[0], nx * ny)
    return RS.bin_triangles(setup, tile_h=tile_h, tile_w=tile_w,
                            n_tiles_x=nx, n_tiles_y=ny,
                            binned_cap=binned_cap)


def _port_raster(tri_data, bbox, width, height, depth_only=False):
    setup = RS.TriangleSetup(
        torch.tensor(np.asarray(tri_data)), torch.tensor(np.asarray(bbox))
    )
    binned = _port_bins(setup, width, height)
    assert binned.overflow == 0
    tri, z, _, _ = R.rasterize(binned, width=width, height=height,
                               depth_only=depth_only)
    return (None if tri is None else tri.numpy()), z.numpy()


def _jax_raster(setup, width, height, tile_h, depth_only=False):
    binned = JRS.bin_triangles(
        setup, tile_h=tile_h, tile_w=128, n_tiles_x=width // 128,
        n_tiles_y=height // tile_h, max_tiles_per_tri=8, binned_cap=1 << 16,
        global_cap=64,
    )
    assert int(binned.overflow) == 0
    tri, z, _, _ = j_rasterize(
        binned, width=width, height=height, tile_h=tile_h, tile_w=128,
        depth_only=depth_only, slim=not depth_only,
    )
    return (None if tri is None else np.asarray(tri)), np.asarray(z)


def _assert_raster_equal(port, ref, what):
    (t_p, z_p), (t_r, z_r) = port, ref
    if t_r is not None:
        mism = int((t_p != t_r).sum())
        print(f"{what}: {mism} id mismatches, covered "
              f"{(t_r >= 0).mean():.3f}, depth max |diff| "
              f"{np.abs(z_p - z_r).max():.3g}")
        np.testing.assert_array_equal(t_p, t_r)
    np.testing.assert_allclose(z_p, z_r, atol=1e-6, rtol=0)


def _soup(seed, n_tri, width, height):
    rng = np.random.RandomState(seed)
    pts = rng.uniform([0, 0], [width, height], size=(n_tri * 3, 2))
    z = rng.uniform(0.05, 0.95, size=n_tri * 3)
    clip = np.stack([
        pts[:, 0] / width * 2.0 - 1.0, pts[:, 1] / height * 2.0 - 1.0, z,
        np.ones(n_tri * 3),
    ], axis=-1).astype(np.float32)
    return clip, np.arange(n_tri * 3, dtype=np.int32).reshape(n_tri, 3)


@pytest.mark.parametrize("seed,n_tri,cull", [
    (42, 50, False), (7, 300, False), (3, 300, True),
])
def test_random_soup_matches_reference(seed, n_tri, cull):
    """test_rasterizer.py:127-144's random soup (and larger ones)."""
    clip, idx = _soup(seed, n_tri, W, H)
    setup = JRS.triangle_setup(
        jnp.asarray(clip), jnp.asarray(idx), jnp.ones(n_tri, bool), W, H,
        cull_backface=cull,
    )
    ref = _jax_raster(setup, W, H, 16)
    port = _port_raster(setup.tri_data, setup.bbox, W, H)
    assert (ref[0] >= 0).sum() > 100
    _assert_raster_equal(port, ref, f"soup {seed}")


def test_random_soup_depth_only_matches_reference():
    clip, idx = _soup(11, 200, W, H)
    setup = JRS.triangle_setup(
        jnp.asarray(clip), jnp.asarray(idx), jnp.ones(200, bool), W, H,
        cull_backface=False,
    )
    ref = _jax_raster(setup, W, H, 16, depth_only=True)
    port = _port_raster(setup.tri_data, setup.bbox, W, H, depth_only=True)
    _assert_raster_equal(port, ref, "soup depth")


def test_shared_edges_cover_once():
    """A fan of triangles sharing edges through pixel centres: the
    top-left rule gives every covered pixel to exactly one triangle,
    identically to the reference."""
    cx, cy = 128.5, 32.5
    ang = np.linspace(0, 2 * np.pi, 13)[:-1]
    ring = np.stack([cx + 40 * np.cos(ang), cy + 24 * np.sin(ang)], -1)
    pts = []
    for i in range(12):
        pts += [[cx, cy], ring[i], ring[(i + 1) % 12]]
    pts = np.round(np.asarray(pts) * 2) / 2  # edges through pixel centres
    clip = np.stack([
        pts[:, 0] / W * 2 - 1, pts[:, 1] / H * 2 - 1,
        np.full(len(pts), 0.5), np.ones(len(pts)),
    ], -1).astype(np.float32)
    idx = np.arange(len(pts), dtype=np.int32).reshape(-1, 3)
    setup = JRS.triangle_setup(
        jnp.asarray(clip), jnp.asarray(idx), jnp.ones(len(idx), bool), W, H,
        cull_backface=False,
    )
    ref = _jax_raster(setup, W, H, 16)
    port = _port_raster(setup.tri_data, setup.bbox, W, H)
    _assert_raster_equal(port, ref, "fan")


def _tiny_scene():
    cfg = graft._tiny_config()
    world = graft._tiny_world()
    cam = graft._camera(cfg)
    world.insert_resource(cam)
    r = JRenderer(cfg)
    r.prepare(world)
    light_pv, _ = find_shadow_light(world)
    params = j_camera_params(cam, light_pv)
    return cfg, r, params


def test_tiny_scene_gbuffer_raster_matches_reference():
    cfg, r, params = _tiny_scene()
    setup = JRS.triangle_setup_from_attrs(
        r.scene.tri_attrs, r.scene.tri_valid, params["proj_view"],
        r.pad_w, r.pad_h, cull_backface=True,
    )
    ref = _jax_raster(setup, r.pad_w, r.pad_h, cfg.tile_h)
    port = _port_raster(setup.tri_data, setup.bbox, r.pad_w, r.pad_h)
    assert 0.1 < (ref[0] >= 0).mean() < 0.95
    _assert_raster_equal(port, ref, "tiny G-buffer")


def test_tiny_scene_shadow_raster_matches_reference():
    cfg, r, params = _tiny_scene()
    s = cfg.shadow_map_size
    setup = JRS.triangle_setup_from_attrs(
        r.scene.tri_attrs, r.scene.tri_valid, params["light_proj_view"],
        s, s, cull_backface=False,
        depth_bias_const=cfg.shadow_depth_bias_const,
        depth_bias_slope=cfg.shadow_depth_bias_slope,
    )
    ref = _jax_raster(setup, s, s, cfg.tile_h, depth_only=True)
    port = _port_raster(setup.tri_data, setup.bbox, s, s, depth_only=True)
    assert (ref[1] < 1.0).mean() > 0.1
    _assert_raster_equal(port, ref, "tiny shadow")


@pytest.mark.parametrize("cull", [True, False])
def test_setup_matches_reference(cull):
    """The port's own setup from the same packed corners: validity, tie
    bits and bboxes as the reference's, and a visibility raster with the
    same ids.  The float rows differ by roundings (XLA fuses multiply-adds
    on the CPU, PyTorch does not), which a sliver triangle's 1/area
    amplifies in its depth plane: depth is held to 1e-4 here, and to 1e-6
    where both rasterizers share the rows (tests above)."""
    cfg, r, params = _tiny_scene()
    pv = np.asarray(params["proj_view"])
    ref = JRS.triangle_setup_from_attrs(
        r.scene.tri_attrs, r.scene.tri_valid, jnp.asarray(pv), r.pad_w,
        r.pad_h, cull_backface=cull,
    )
    port = RS.triangle_setup_from_attrs(
        torch.tensor(np.asarray(r.scene.tri_attrs)),
        torch.tensor(np.asarray(r.scene.tri_valid)),
        torch.from_numpy(pv), r.pad_w, r.pad_h, cull_backface=cull,
    )
    td_r, td_p = np.asarray(ref.tri_data), port.tri_data.numpy()
    np.testing.assert_array_equal(td_p[:, RS.COL_VALID], td_r[:, RS.COL_VALID])
    np.testing.assert_array_equal(td_p[:, RS.COL_TIE], td_r[:, RS.COL_TIE])
    assert np.abs(port.bbox.numpy() - np.asarray(ref.bbox)).max() <= 1
    t_p, z_p = _port_raster(port.tri_data, port.bbox, r.pad_w, r.pad_h)
    t_r, z_r = _jax_raster(ref, r.pad_w, r.pad_h, cfg.tile_h)
    print(f"own setup: {(t_p != t_r).sum()} id mismatches, depth max "
          f"|diff| {np.abs(z_p - z_r).max():.3g}")
    np.testing.assert_array_equal(t_p, t_r)
    np.testing.assert_allclose(z_p, z_r, atol=1e-4, rtol=0)


def test_binning_lists_every_pair_in_draw_order():
    """Each tile's run is exactly the triangles whose bbox touches it,
    ascending (draw order), and pairs past binned_cap count as
    overflow."""
    clip, idx = _soup(5, 120, W, H)
    setup = JRS.triangle_setup(
        jnp.asarray(clip), jnp.asarray(idx), jnp.ones(120, bool), W, H,
        cull_backface=False,
    )
    tri_data = torch.tensor(np.asarray(setup.tri_data))
    bbox = torch.tensor(np.asarray(setup.bbox))
    b = _port_bins(RS.TriangleSetup(tri_data, bbox), W, H, 16, 64)
    bb = bbox.numpy()
    live = (tri_data[:, RS.COL_VALID].numpy() > 0) & (bb[:, 0] <= bb[:, 2])
    total = 0
    for ty in range(H // 16):
        for tx in range(W // 64):
            k = ty * (W // 64) + tx
            s, c = int(b.tile_start[k]), int(b.tile_count[k])
            run = b.pair_tri[s : s + c].numpy()
            want = np.nonzero(
                live & (bb[:, 0] // 64 <= tx) & (bb[:, 2] // 64 >= tx)
                & (bb[:, 1] // 16 <= ty) & (bb[:, 3] // 16 >= ty)
            )[0]
            np.testing.assert_array_equal(run, want)
            total += c
    assert b.overflow == 0 and b.pair_tri.shape[0] == RS.pair_capacity(
        120, (W // 64) * (H // 16))
    capped = _port_bins(RS.TriangleSetup(tri_data, bbox), W, H, 16, 64,
                        binned_cap=total - 10)
    assert capped.overflow == 10


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """Dispatch is by device: a CPU tensor runs the plain version and
    never touches the kernel library."""
    from mo_renderer_tpu_torch.kernels import _build

    def boom(*a, **k):
        raise AssertionError("kernel library touched for a CPU tensor")

    monkeypatch.setattr(_build, "library", boom)
    clip, idx = _soup(1, 20, W, H)
    setup = JRS.triangle_setup(
        jnp.asarray(clip), jnp.asarray(idx), jnp.ones(20, bool), W, H,
    )
    _port_raster(setup.tri_data, setup.bbox, W, H)


def _covered_outside_box(tri_data, bbox, width, height, chunk=256):
    """Count the (triangle, pixel) candidates the raster rule covers
    (edges accepted and z >= 0, the plain version's arithmetic) that lie
    outside the triangle's inclusive pixel box, over ALL live triangles
    and ALL pixels of the target -- not only the winners."""
    live = (tri_data[:, RS.COL_VALID] > 0) & (bbox[:, 0] <= bbox[:, 2])
    rows, boxes = tri_data[live], bbox[live].to(torch.int64)
    ys, xs = torch.meshgrid(torch.arange(height), torch.arange(width),
                            indexing="ij")
    px = (xs.to(torch.float32) + 0.5)[None]
    py = (ys.to(torch.float32) + 0.5)[None]
    outside_covered, covered = 0, 0
    for lo in range(0, rows.shape[0], chunk):
        r = rows[lo : lo + chunk]
        b = boxes[lo : lo + chunk, :, None, None]

        def col(j):
            return r[:, j, None, None]

        tb = r[:, RS.COL_TIE].to(torch.int32)[:, None, None]
        cover = torch.ones((r.shape[0], height, width), dtype=torch.bool)
        for i, bit in enumerate((1, 2, 4)):
            w = R._edge(col(i), col(3 + i), col(6 + i), px, py)
            cover &= (w > 0) | (((tb & bit) > 0) & (w == 0))
        cover &= R._fused(col(9), col(10), col(11), px, py) >= 0.0
        inside = ((xs >= b[:, 0]) & (xs <= b[:, 2])
                  & (ys >= b[:, 1]) & (ys <= b[:, 3]))
        covered += int(cover.sum())
        outside_covered += int((cover & ~inside).sum())
    return outside_covered, covered


@pytest.mark.parametrize("seed,n_tri,cull", [
    (42, 50, False), (7, 300, False), (3, 300, True), (11, 200, False),
])
def test_soup_coverage_stays_inside_the_boxes(seed, n_tri, cull):
    """What the CUDA rasterizer's skip by box relies on: no triangle
    covers a pixel outside its box (the port's own setup)."""
    clip, idx = _soup(seed, n_tri, W, H)
    setup = RS.triangle_setup(
        torch.from_numpy(clip), torch.from_numpy(idx),
        torch.ones(n_tri, dtype=torch.bool), W, H, cull_backface=cull,
    )
    outside, covered = _covered_outside_box(setup.tri_data, setup.bbox, W, H)
    assert covered > 1000 and outside == 0


def _near_plane_soup(seed, n_tri, n_near, width, height):
    """Triangles with ``n_near`` corners each just in front of the eye
    plane (w from 1.1e-6, right behind the setup's cut, to 0.1; clip x, y
    of order 1, so screen coordinates reach 1e8 pixels and more) and the
    other corners on or around the target."""
    rng = np.random.default_rng(seed)
    ndc = rng.uniform(-1.2, 1.2, size=(n_tri, 3, 2))
    w = np.ones((n_tri, 3))
    w[:, :n_near] = np.exp(rng.uniform(np.log(1.1e-6), np.log(0.1),
                                       size=(n_tri, n_near)))
    xy = ndc.copy()
    xy[:, n_near:] *= w[:, n_near:, None]
    z = rng.uniform(0.05, 0.95, size=(n_tri, 3)) * w
    clip = np.concatenate([xy, z[..., None], w[..., None]], -1)
    return (clip.reshape(-1, 4).astype(np.float32),
            np.arange(n_tri * 3, dtype=np.int32).reshape(n_tri, 3))


@pytest.mark.parametrize("seed,n_near", [(0, 1), (1, 2), (2, 1)])
def test_near_plane_triangles_get_the_box_of_their_tiles(seed, n_near):
    """A corner right in front of the eye plane throws an edge over
    millions of pixels; there the float edge functions can cover pixels
    outside the setup's box.  Binning hands such triangles (an edge longer
    than MAX_EXACT_EXTENT) the box of the tiles they are binned to, where
    every rasterizer tests them anyway, and all others keep their own box
    and cover nothing outside it."""
    n_tri = 300
    clip, idx = _near_plane_soup(seed, n_tri, n_near, W, H)
    setup = RS.triangle_setup(
        torch.from_numpy(clip), torch.from_numpy(idx),
        torch.ones(n_tri, dtype=torch.bool), W, H, cull_backface=False,
    )
    binned = _port_bins(setup, W, H)
    live = (setup.tri_data[:, RS.COL_VALID] > 0) & (
        setup.bbox[:, 0] <= setup.bbox[:, 2])
    extent = setup.tri_data[:, :RS.COL_C0].abs().amax(1)
    huge = live & (extent > RS.MAX_EXACT_EXTENT)
    assert int(huge.sum()) > 20 and int((live & ~huge).sum()) > 20
    assert torch.equal(binned.bbox[~huge], setup.bbox[~huge])
    bb = setup.bbox[huge].to(torch.int64)
    tiles = torch.stack([
        bb[:, 0] // R.BIN_W * R.BIN_W, bb[:, 1] // R.BIN_H * R.BIN_H,
        bb[:, 2] // R.BIN_W * R.BIN_W + R.BIN_W - 1,
        bb[:, 3] // R.BIN_H * R.BIN_H + R.BIN_H - 1,
    ], -1)
    assert torch.equal(binned.bbox[huge].to(torch.int64), tiles)
    keep = live & ~huge
    outside, covered = _covered_outside_box(
        setup.tri_data[keep], setup.bbox[keep], W, H)
    assert covered > 1000 and outside == 0


def _jax_grid_world(n_grid):
    """scenes.grid_world built from the JAX package's classes (the scene
    of examples/sponza_scale.py, with the synthetic-sky IBL)."""
    from mo_renderer_tpu.assets.procedural import procedural_model
    from mo_renderer_tpu.math.transform import Transform
    from mo_renderer_tpu.scene.components import DirectionalLight, PointLight
    from mo_renderer_tpu.scene.world import World

    world = World()
    world.spawn((
        Transform.from_xyz(0.0, 0.0, 0.0),
        procedural_model("plane", size=40.0, textured=True, roughness=0.8),
    ))
    rng = np.random.default_rng(42)
    for i in range(n_grid):
        for j in range(n_grid):
            x = (i - (n_grid - 1) / 2) * 2.4
            z = (j - (n_grid - 1) / 2) * 2.4
            color = tuple(rng.uniform(0.2, 1.0, 3)) + (1.0,)
            model = procedural_model(
                "cube" if (i + j) % 2 == 0 else "sphere",
                base_color=color,
                metallic=float((i * n_grid + j) % 3 == 0),
                roughness=float(0.1 + 0.8 * rng.random()),
                textured=(i + j) % 5 == 0,
            )
            world.spawn((
                Transform.from_xyz(x, 0.5 + 0.8 * rng.random(), z), model,
            ))
    world.spawn((DirectionalLight(
        Transform.from_xyz(20.0, 30.0, 10.0).looking_at((0.0, 0.0, 0.0)),
        (1.0, 0.98, 0.9), 3.0, True, shadow_width=40.0, shadow_height=40.0,
    ),))
    for k in range(4):
        ang = k * np.pi / 2 + 0.4
        world.spawn((PointLight(
            Transform.from_xyz(8 * np.cos(ang), 3.0, 8 * np.sin(ang)),
            color=[(1, .3, .2), (.2, 1, .3), (.3, .4, 1), (1, 1, .5)][k],
            intensity=8.0,
        ),))
    world.insert_resource(graft._tiny_ibl())
    return world


def _jax_grid_camera(cfg):
    from mo_renderer_tpu.math import quat
    from mo_renderer_tpu.scene.camera import Camera

    yaw = np.pi * 0.8
    d = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
    cam = Camera(
        position=tuple(-14.0 * d + np.array([0.0, 4.0, 0.0])),
        rotation=quat.mul(quat.from_rotation_y(yaw),
                          quat.from_rotation_x(-0.2)),
    )
    cam.resize((cfg.width, cfg.height))
    return cam


@pytest.fixture(scope="module")
def grid_scene():
    """grid_world(3) at 256x128 in both packages: the renderers, prepared,
    and the JAX camera parameters."""
    from mo_renderer_tpu_torch import Renderer, scenes

    jcfg = graft._tiny_config()
    jworld = _jax_grid_world(3)
    jcam = _jax_grid_camera(jcfg)
    jworld.insert_resource(jcam)
    jr = JRenderer(jcfg)
    jr.prepare(jworld)
    light_pv, _ = find_shadow_light(jworld)
    cfg = scenes.tiny_config()
    world = scenes.grid_world(3)
    world.insert_resource(scenes.grid_camera(cfg))
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    return dict(jcfg=jcfg, jr=jr, jworld=jworld,
                jparams=j_camera_params(jcam, light_pv), r=r, world=world)


def test_grid_scene_is_the_reference_scene(grid_scene):
    """The port's grid_world packs the triangles the JAX classes pack, and
    its camera and light give the same matrices."""
    jr, r = grid_scene["jr"], grid_scene["r"]
    params, _ = r.frame_params(grid_scene["world"])
    np.testing.assert_array_equal(r.scene.tri_valid.numpy(),
                                  np.asarray(jr.scene.tri_valid))
    np.testing.assert_allclose(r.scene.tri_attrs.numpy(),
                               np.asarray(jr.scene.tri_attrs), atol=1e-6)
    assert int(r.scene.tri_valid.sum()) == 4 * 1024 + 5 * 12 + 2
    for key in ("proj_view", "light_proj_view"):
        np.testing.assert_allclose(
            params[key].numpy(), np.asarray(grid_scene["jparams"][key]),
            atol=1e-6)


@pytest.mark.parametrize("target", ["camera", "light"])
def test_grid_scene_raster_matches_reference(grid_scene, target):
    """grid_world(3): visibility ids exact and depth within 1e-6 against
    the JAX rasterizer on the same setup rows, from the camera and (depth
    only) from the light; and no coverage outside the boxes."""
    jcfg, jr, params = (grid_scene[k] for k in ("jcfg", "jr", "jparams"))
    if target == "camera":
        w, h, depth_only = jr.pad_w, jr.pad_h, False
        setup = JRS.triangle_setup_from_attrs(
            jr.scene.tri_attrs, jr.scene.tri_valid, params["proj_view"],
            w, h, cull_backface=True,
        )
    else:
        w = h = jcfg.shadow_map_size
        depth_only = True
        setup = JRS.triangle_setup_from_attrs(
            jr.scene.tri_attrs, jr.scene.tri_valid,
            params["light_proj_view"], w, h, cull_backface=False,
            depth_bias_const=jcfg.shadow_depth_bias_const,
            depth_bias_slope=jcfg.shadow_depth_bias_slope,
        )
    ref = _jax_raster(setup, w, h, jcfg.tile_h, depth_only=depth_only)
    port = _port_raster(setup.tri_data, setup.bbox, w, h,
                        depth_only=depth_only)
    assert (ref[1] < 1.0).mean() > 0.05
    _assert_raster_equal(port, ref, f"grid {target}")
    outside, covered = _covered_outside_box(
        torch.tensor(np.asarray(setup.tri_data)),
        torch.tensor(np.asarray(setup.bbox)), w, h,
    )
    assert covered > 1000 and outside == 0


def test_grid_scene_rasterize_attrs_matches_reference(grid_scene):
    """The megakernel on grid_world(3), rows built as the JAX megakernel
    branch builds them (frame_graph.py:320-343): ids, material and
    handedness planes exact, depth atol 1e-6, the 14 interpolated planes
    rtol 2e-3 / atol 1e-4 against the JAX kernel in interpret mode."""
    jcfg, jr, params = (grid_scene[k] for k in ("jcfg", "jr", "jparams"))
    w, h = jr.pad_w, jr.pad_h
    vs = JV.run_vertex_stage(jr.scene, params["proj_view"],
                             params["prev_proj_view"],
                             params["light_proj_view"])
    setup = JRS.triangle_setup(vs.clip, jr.scene.indices, jr.scene.tri_valid,
                               w, h, cull_backface=True)
    extra = JV.pack_raster_attr_columns(jr.scene.tri_attrs,
                                        params["proj_view"])
    rows = jnp.concatenate([setup.tri_data, extra], axis=1)
    binned = JRS.bin_triangles(
        JRS.TriangleSetup(tri_data=rows, bbox=setup.bbox),
        tile_h=jcfg.tile_h, tile_w=jcfg.tile_w, n_tiles_x=w // jcfg.tile_w,
        n_tiles_y=h // jcfg.tile_h, max_tiles_per_tri=8,
        binned_cap=1 << 16, global_cap=64,
    )
    assert int(binned.overflow) == 0
    tri_w, z_w, planes_w, mat_w, ht_w = j_rasterize_attrs(
        binned, width=w, height=h, tile_h=jcfg.tile_h, tile_w=jcfg.tile_w)
    port_binned, attr_rows = R.split_attr_rows(_port_bins(
        RS.TriangleSetup(torch.tensor(np.asarray(rows)),
                         torch.tensor(np.asarray(setup.bbox))), w, h))
    tri_g, z_g, planes_g, mat_g, ht_g = R.rasterize_attrs(
        port_binned, width=w, height=h, attr_rows=attr_rows)
    assert (np.asarray(tri_w) >= 0).mean() > 0.05
    np.testing.assert_array_equal(tri_g.numpy(), np.asarray(tri_w))
    np.testing.assert_array_equal(mat_g.numpy(), np.asarray(mat_w))
    np.testing.assert_array_equal(ht_g.numpy(), np.asarray(ht_w))
    np.testing.assert_allclose(z_g.numpy(), np.asarray(z_w), atol=1e-6,
                               rtol=0)
    assert len(planes_g) == len(planes_w) == V.RA_N_INTERP
    for i, (a, b) in enumerate(zip(planes_g, planes_w)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=1e-4, err_msg=f"plane {i}")


def _port_megakernel_setup(grid_scene):
    """The port's own megakernel inputs on grid_world(3): the setup from
    its vertex stage's clip positions, and the attribute columns."""
    r = grid_scene["r"]
    params, _ = r.frame_params(grid_scene["world"])
    vs = V.run_vertex_stage(r.scene, params["proj_view"],
                            params["prev_proj_view"],
                            params["light_proj_view"])
    setup = RS.triangle_setup(vs.clip, r.scene.indices, r.scene.tri_valid,
                              r.pad_w, r.pad_h, cull_backface=True)
    return r, setup, params["proj_view"]


def test_grid_scene_megakernel_coverage_stays_inside_the_boxes(grid_scene):
    """What the megakernel's skip by box relies on: its setup (from
    per-vertex clip positions, not the packed corners) covers no pixel
    outside a triangle's box either."""
    r, setup, _ = _port_megakernel_setup(grid_scene)
    outside, covered = _covered_outside_box(setup.tri_data, setup.bbox,
                                            r.pad_w, r.pad_h)
    assert covered > 1000 and outside == 0


def test_split_attr_rows_give_the_same_planes(grid_scene):
    """The megakernel's two aligned tensors, (T, 16) raster rows and
    (T, 48) attribute rows, against the reference's (T, 63) rows split
    on the way in: the same columns, and every output equal."""
    r, setup, proj_view = _port_megakernel_setup(grid_scene)
    attr_rows = V.pack_raster_attr_rows(r.scene.tri_attrs, proj_view)
    assert attr_rows.shape == (setup.tri_data.shape[0], R.ATTR_ROW)
    assert attr_rows.is_contiguous()
    assert bool((attr_rows[:, R.ATTR_COLS:] == 0).all())
    cols = attr_rows[:, : R.ATTR_COLS]

    def bin_(tri_data):
        return _port_bins(RS.TriangleSetup(tri_data, setup.bbox), r.pad_w,
                          r.pad_h)

    binned, from_joined = R.split_attr_rows(
        bin_(torch.cat([setup.tri_data, cols], dim=1)))
    assert binned.tri_data.shape[1] == 16 and binned.tri_data.is_contiguous()
    assert torch.equal(from_joined, attr_rows)
    joined = R.rasterize_attrs(binned, width=r.pad_w, height=r.pad_h,
                               attr_rows=from_joined)
    split = R.rasterize_attrs(bin_(setup.tri_data), width=r.pad_w,
                              height=r.pad_h, attr_rows=attr_rows)
    assert bool((split[0] >= 0).any())
    for a, b in zip(joined[:2] + joined[2] + joined[3:],
                    split[:2] + split[2] + split[3:]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        R.split_attr_rows(bin_(setup.tri_data))
    with pytest.raises(ValueError):
        R.rasterize_attrs(bin_(setup.tri_data), width=r.pad_w,
                          height=r.pad_h, attr_rows=cols)


def test_grid_scene_default_frame_matches_reference(grid_scene):
    """The default frame of grid_world(3) at 256x128 within the golden bar
    of tests/test_golden.py:99-107 (mean |diff| < 2/255, fewer than 0.5%
    of channels above 16/255) against the JAX frame."""
    frame = grid_scene["r"].render(grid_scene["world"]).astype(np.int32)
    ref = np.asarray(
        grid_scene["jr"].render(grid_scene["jworld"])).astype(np.int32)
    assert frame.shape == ref.shape == (128, 256, 4)
    diff = np.abs(frame - ref)[..., :3]
    print(f"grid frame: max |diff| {diff.max()} LSB, mean {diff.mean():.4f}, "
          f"{(diff > 16).mean():.4%} > 16")
    assert diff.mean() < 2.0
    assert (diff > 16).mean() < 0.005


def test_grid_world_default_is_the_stress_scene():
    """grid_world() is the reference's 10 x 10 stress scene: 50 spheres of
    1024 triangles, 50 cubes of 12 and the plane, a fifth of the objects
    textured, one shadow-casting sun and four point lights."""
    from mo_renderer_tpu_torch import scenes
    from mo_renderer_tpu_torch.assets.model import Model
    from mo_renderer_tpu_torch.scene.components import (
        DirectionalLight,
        PointLight,
    )

    world = scenes.grid_world()
    models = list(world.query(Model))
    n_tri = sum(m.primitive.indices.size // 3
                for model in models for m in model.meshes)
    assert len(models) == 101 and n_tri == 50 * 1024 + 50 * 12 + 2
    assert sum(bool(model.textures) for model in models) == 1 + 20
    suns = list(world.query(DirectionalLight))
    assert len(suns) == 1 and suns[0].is_shadow_caster
    assert suns[0].shadow_width == suns[0].shadow_height == 40.0
    assert len(list(world.query(PointLight))) == 4
