"""The vertex-stage paths of the port (the reference sampling path and the
raster megakernel) against the JAX functions on the same inputs: the
per-vertex stage, triangle setup from clip positions, the full-mode
raster (K6) and the megakernel (K8) in their plain versions, the
reference samplers, ``gbuffer_pass`` / ``calculate_shadow`` /
``shading_pass``, ``pack_raster_attr_columns`` and
``gbuffer_pass_from_planes``.  The JAX rasterizers run their Pallas
kernels in interpret mode on the CPU, as the JAX package's own tests do.

Bars:
- clip positions and rasterized ids exact (the coverage edges hang on
  them); depth and K6's barycentrics atol 1e-6 on covered pixels
  (tests/test_rasterizer.py:138-146);
- K8: ids, material and handedness planes exact, depth atol 1e-6, the
  14 interpolated planes rtol 2e-3 / atol 1e-4 (tests/test_attr_planes.py);
- samplers, G-buffer fields and colours at float tolerance (stated per
  test: the reference's CPU evaluation fuses some multiply-adds);
- the shadow map atol 1e-6 and the shadow factor exact but on a stated
  fraction of pixels, since one ulp of map depth flips a ``current >
  closest`` tap.
"""

import dataclasses
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mo_renderer_tpu.device import sampling as JS  # noqa: E402
from mo_renderer_tpu.kernels import raster_setup as JRS  # noqa: E402
from mo_renderer_tpu.kernels.raster_reference import (  # noqa: E402
    rasterize_reference,
)
from mo_renderer_tpu.kernels.rasterizer import (  # noqa: E402
    rasterize as j_rasterize,
    rasterize_attrs as j_rasterize_attrs,
)
from mo_renderer_tpu.passes import gbuffer as JG  # noqa: E402
from mo_renderer_tpu.passes import shading as JSh  # noqa: E402
from mo_renderer_tpu.passes import vertex_stage as JV  # noqa: E402
from mo_renderer_tpu.passes.frame_graph import (  # noqa: E402
    Renderer as JRenderer,
    _shadow_map_from_clip,
    build_camera_params as j_camera_params,
)
from mo_renderer_tpu.scene.scene_buffers import find_shadow_light  # noqa: E402
from mo_renderer_tpu_torch import interop  # noqa: E402
from mo_renderer_tpu_torch.device import sampling as S  # noqa: E402
from mo_renderer_tpu_torch.kernels import raster_setup as RS  # noqa: E402
from mo_renderer_tpu_torch.kernels import rasterizer as R  # noqa: E402
from mo_renderer_tpu_torch.passes import gbuffer as G  # noqa: E402
from mo_renderer_tpu_torch.passes import shading as Sh  # noqa: E402
from mo_renderer_tpu_torch.passes import vertex_stage as V  # noqa: E402
from mo_renderer_tpu_torch.passes.frame_graph import (  # noqa: E402
    CameraParams,
    shadow_map_from_clip,
)


def t(a):
    return torch.from_numpy(np.array(a))


def n(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# --- shared state: the tiny scene through the JAX vertex path ---------------

@pytest.fixture(scope="module")
def tiny():
    cfg = graft._tiny_config()
    world = graft._tiny_world()
    cam = graft._camera(cfg)
    world.insert_resource(cam)
    jr = JRenderer(cfg)
    jr.prepare(world)
    light_pv, _ = find_shadow_light(world)
    params = j_camera_params(cam, light_pv)
    vs = JV.run_vertex_stage(jr.scene, params["proj_view"],
                             params["prev_proj_view"],
                             params["light_proj_view"])
    scene = interop.scene_from_numpy(
        {k: np.asarray(getattr(jr.scene, k))
         for k in jr.scene.__dataclass_fields__}, "cpu",
    )
    p = CameraParams(t(params.vec))
    return types.SimpleNamespace(
        cfg=cfg, jr=jr, jscene=jr.scene, params=params, vs=vs, scene=scene,
        p=p, pvs=V.run_vertex_stage(scene, p["proj_view"],
                                    p["prev_proj_view"],
                                    p["light_proj_view"]),
    )


def _j_full_raster(tiny_, clip=None):
    """The JAX reference path's G-buffer raster of the tiny scene."""
    r, cfg = tiny_.jr, tiny_.cfg
    setup = JRS.triangle_setup(
        tiny_.vs.clip if clip is None else clip, tiny_.jscene.indices,
        tiny_.jscene.tri_valid, r.pad_w, r.pad_h, cull_backface=True,
    )
    binned = JRS.bin_triangles(
        setup, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
        n_tiles_x=r.pad_w // cfg.tile_w, n_tiles_y=r.pad_h // cfg.tile_h,
        max_tiles_per_tri=8, binned_cap=r._binned_cap, global_cap=512,
    )
    return setup, j_rasterize(binned, width=r.pad_w, height=r.pad_h,
                              tile_h=cfg.tile_h, tile_w=cfg.tile_w)


def _port_bin(tri_data, bbox, width, height):
    nx, ny = -(-width // R.BIN_W), -(-height // R.BIN_H)
    binned = RS.bin_triangles(
        RS.TriangleSetup(t(tri_data), t(bbox)), tile_h=R.BIN_H,
        tile_w=R.BIN_W, n_tiles_x=nx, n_tiles_y=ny,
        binned_cap=RS.pair_capacity(bbox.shape[0], nx * ny),
    )
    assert int(binned.overflow) == 0
    return binned


# --- vertex stage and setup -------------------------------------------------

def _random_scene(seed, v=1024, m=3):
    rng = np.random.default_rng(seed)
    world = rng.normal(size=(m, 4, 4)).astype(np.float32) * 0.5
    world[:, 3] = [0, 0, 0, 1]
    world[:, :3, :3] += np.eye(3, dtype=np.float32)
    nmat = np.stack([np.linalg.inv(w[:3, :3]).T for w in world])
    tangent = rng.normal(size=(v, 4)).astype(np.float32)
    tangent[:, 3] = np.sign(tangent[:, 3])
    tangent[: v // 8, :3] = 0.0  # vertices without tangents
    return dict(
        position=rng.normal(size=(v, 3)).astype(np.float32) * 2,
        normal=rng.normal(size=(v, 3)).astype(np.float32),
        tangent=tangent,
        vertex_mesh=rng.integers(0, m, v).astype(np.int32),
        mesh_world=world,
        mesh_normal_mat=nmat.astype(np.float32),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_run_vertex_stage_matches_reference(seed):
    fields = _random_scene(seed)
    rng = np.random.default_rng(100 + seed)
    pvs = [rng.normal(size=(4, 4)).astype(np.float32) for _ in range(3)]
    want = JV.run_vertex_stage(
        types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in fields.items()}),
        *map(jnp.asarray, pvs),
    )
    got = V.run_vertex_stage(
        types.SimpleNamespace(**{k: t(v) for k, v in fields.items()}),
        *map(t, pvs),
    )
    for f in ("world_pos", "clip", "prev_clip", "shadow_clip", "inv_w",
              "has_tangent"):
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      n(getattr(want, f)), err_msg=f)
    for f in ("world_normal", "world_tangent", "world_bitangent"):
        np.testing.assert_allclose(n(getattr(got, f)), n(getattr(want, f)),
                                   atol=1e-6, rtol=0, err_msg=f)


def test_tiny_scene_vertex_stage_matches_reference(tiny):
    """Positions exact; the normalized directions to an ulp (the
    reference's rsqrt is one ulp off the correctly rounded value on some
    inputs)."""
    for f in dataclasses.fields(tiny.pvs):
        got, want = n(getattr(tiny.pvs, f.name)), n(getattr(tiny.vs, f.name))
        if f.name in ("world_normal", "world_tangent", "world_bitangent"):
            np.testing.assert_allclose(got, want, atol=2.5e-7, rtol=0,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f.name)


@pytest.mark.parametrize("cull,bias", [(True, 0.0), (False, 2.0)])
def test_triangle_setup_matches_reference(tiny, cull, bias):
    """From the same per-vertex clip positions: validity, tie bits and
    bboxes exact, the float rows to float tolerance (XLA fuses
    multiply-adds on the CPU; a sliver's 1/area amplifies that in its
    depth plane), and the same visibility."""
    r = tiny.jr
    kw = dict(cull_backface=cull, depth_bias_const=bias,
              depth_bias_slope=bias)
    want = JRS.triangle_setup(tiny.vs.clip, tiny.jscene.indices,
                              tiny.jscene.tri_valid, r.pad_w, r.pad_h, **kw)
    got = RS.triangle_setup(tiny.pvs.clip, tiny.scene.indices,
                            tiny.scene.tri_valid, r.pad_w, r.pad_h, **kw)
    td_w, td_g = n(want.tri_data), n(got.tri_data)
    for col in (RS.COL_VALID, RS.COL_TIE, RS.COL_TRI_ID):
        np.testing.assert_array_equal(td_g[:, col], td_w[:, col])
    np.testing.assert_array_equal(n(got.bbox), n(want.bbox))
    live = td_w[:, RS.COL_VALID] > 0
    np.testing.assert_allclose(td_g[live, :9], td_w[live, :9], rtol=1e-6,
                               atol=1e-4)
    tri_g, _, _, _ = R.rasterize(_port_bin(td_g, n(got.bbox), r.pad_w,
                                           r.pad_h),
                                 width=r.pad_w, height=r.pad_h, slim=True)
    tri_w, _, _, _ = R.rasterize(_port_bin(td_w, n(want.bbox), r.pad_w,
                                           r.pad_h),
                                 width=r.pad_w, height=r.pad_h, slim=True)
    np.testing.assert_array_equal(n(tri_g), n(tri_w))


# --- K6: the full-mode raster --------------------------------------------------

W, H = 256, 64


def _soup(seed, n_tri):
    rng = np.random.RandomState(seed)
    pts = rng.uniform([0, 0], [W, H], size=(n_tri * 3, 2))
    z = rng.uniform(0.05, 0.95, size=n_tri * 3)
    clip = np.stack([pts[:, 0] / W * 2.0 - 1.0, pts[:, 1] / H * 2.0 - 1.0,
                     z, np.ones(n_tri * 3)], axis=-1).astype(np.float32)
    return clip, np.arange(n_tri * 3, dtype=np.int32).reshape(n_tri, 3)


def _assert_full_equal(got, want, what):
    tri_g, z_g, b0_g, b1_g = map(n, got)
    tri_w, z_w, b0_w, b1_w = map(n, want)
    cov = tri_w >= 0
    print(f"{what}: {(tri_g != tri_w).sum()} id mismatches, covered "
          f"{cov.mean():.3f}, b0 max |diff| "
          f"{np.abs(b0_g - b0_w)[cov].max():.3g}")
    np.testing.assert_array_equal(tri_g, tri_w)
    for a, b, name in ((z_g, z_w, "z"), (b0_g, b0_w, "b0"),
                       (b1_g, b1_w, "b1")):
        np.testing.assert_allclose(a[cov], b[cov], atol=1e-6, rtol=0,
                                   err_msg=name)
    np.testing.assert_array_equal(b0_g[~cov & (z_g >= 1.0)], 0.0)


@pytest.mark.parametrize("seed,n_tri,cull", [(42, 50, False),
                                             (7, 300, False), (3, 300, True)])
def test_full_raster_matches_reference_on_soups(seed, n_tri, cull):
    clip, idx = _soup(seed, n_tri)
    setup = JRS.triangle_setup(jnp.asarray(clip), jnp.asarray(idx),
                               jnp.ones(n_tri, bool), W, H,
                               cull_backface=cull)
    binned = JRS.bin_triangles(
        setup, tile_h=16, tile_w=128, n_tiles_x=W // 128, n_tiles_y=H // 16,
        max_tiles_per_tri=8, binned_cap=1 << 16, global_cap=64,
    )
    want = j_rasterize(binned, width=W, height=H, tile_h=16, tile_w=128)
    oracle = rasterize_reference(setup, W, H)
    got = R.rasterize(_port_bin(setup.tri_data, setup.bbox, W, H), width=W,
                      height=H)
    assert (n(want[0]) >= 0).sum() > 100
    _assert_full_equal(got, want, f"soup {seed} vs Pallas")
    _assert_full_equal(got, oracle, f"soup {seed} vs oracle")


def test_full_raster_matches_reference_on_tiny_scene(tiny):
    r = tiny.jr
    setup, want = _j_full_raster(tiny)
    got = R.rasterize(_port_bin(setup.tri_data, setup.bbox, r.pad_w,
                                r.pad_h), width=r.pad_w, height=r.pad_h)
    assert 0.1 < (n(want[0]) >= 0).mean() < 0.95
    _assert_full_equal(got, want, "tiny scene")
    # the slim and depth-only modes keep the full mode's ids and depth
    binned = _port_bin(setup.tri_data, setup.bbox, r.pad_w, r.pad_h)
    tri_s, z_s, b0_s, _ = R.rasterize(binned, width=r.pad_w,
                                      height=r.pad_h, slim=True)
    assert b0_s is None
    np.testing.assert_array_equal(n(tri_s), n(got[0]))
    np.testing.assert_array_equal(n(z_s), n(got[1]))


# --- reference samplers --------------------------------------------------------

@pytest.mark.parametrize("mode", [JS.CLAMP_TO_EDGE, JS.REPEAT])
def test_sample_bilinear_matches_reference(mode):
    rng = np.random.default_rng(5)
    tex = rng.uniform(size=(24, 40, 3)).astype(np.float32)
    uv = rng.uniform(-1.5, 2.5, size=(64, 96, 2)).astype(np.float32)
    want = JS.sample_bilinear(jnp.asarray(tex), jnp.asarray(uv), mode)
    got = S.sample_bilinear(t(tex), t(uv), mode)
    np.testing.assert_allclose(n(got), n(want), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(n(S.wrap_index(t(np.arange(-70, 70)), 40,
                                                 mode)),
                                  n(JS.wrap_index(jnp.arange(-70, 70), 40,
                                                  mode)))


def test_sample_array_bilinear_matches_reference():
    rng = np.random.default_rng(6)
    tex = rng.integers(0, 256, size=(5, 16, 16, 4)).astype(np.uint8)
    layer = rng.integers(0, 5, size=(48, 64)).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, size=(48, 64, 2)).astype(np.float32)
    for mode in (JS.REPEAT, JS.CLAMP_TO_EDGE):
        want = JS.sample_array_bilinear(jnp.asarray(tex), jnp.asarray(layer),
                                        jnp.asarray(uv), mode)
        got = S.sample_array_bilinear(t(tex), t(layer), t(uv), mode)
        np.testing.assert_allclose(n(got), n(want), atol=1e-6, rtol=0)


def test_cubemap_samplers_match_reference():
    rng = np.random.default_rng(8)
    mips = [rng.uniform(size=(6, s, s, 3)).astype(np.float32)
            for s in (16, 8, 4)]
    dirs = rng.normal(size=(40, 50, 3)).astype(np.float32)
    lod = rng.uniform(-0.5, 3.5, size=(40, 50)).astype(np.float32)
    want = JS.sample_cubemap(jnp.asarray(mips[0]), jnp.asarray(dirs))
    got = S.sample_cubemap(t(mips[0]), t(dirs))
    np.testing.assert_allclose(n(got), n(want), atol=1e-6, rtol=0)
    jmc = JS.MipCube([jnp.asarray(m) for m in mips])
    mc = S.MipCube.from_mips([t(m) for m in mips])
    want = JS.sample_mipcube_lod(jmc, jnp.asarray(dirs), jnp.asarray(lod))
    got = S.sample_mipcube_lod(mc, t(dirs), t(lod))
    np.testing.assert_allclose(n(got), n(want), atol=1e-6, rtol=0)


# --- reference-path G-buffer and shading ------------------------------------

def _to_port_gbuf(jg):
    return G.GBuffer(**{f.name: t(getattr(jg, f.name))
                        for f in dataclasses.fields(jg)})


def _close_gbuf(got, want, atols):
    np.testing.assert_array_equal(n(got.mask), n(want.mask))
    np.testing.assert_array_equal(n(got.depth), n(want.depth))
    for field, atol in atols:
        a, b = n(getattr(got, field)), n(getattr(want, field))
        print(f"{field}: max |diff| {np.abs(a - b).max():.3g}")
        np.testing.assert_allclose(a, b, atol=atol, rtol=1e-5, err_msg=field)


@pytest.mark.parametrize("uv1", [False, True])
def test_gbuffer_pass_matches_reference(tiny, uv1):
    """Same visibility buffer and scene state; each side's own vertex
    stage.  ``uv1``: every slot of the cube's material samples UV set 1."""
    _, (tri, z, b0, b1) = _j_full_raster(tiny)
    jscene, scene = tiny.jscene, tiny.scene
    if uv1:
        mats = np.array(jscene.materials)
        mats[:, 5:10] = 1.0
        jscene = dataclasses.replace(jscene, materials=jnp.asarray(mats),
                                     uv1=jscene.uv1 * 2.0)
        scene = dataclasses.replace(scene, materials=t(mats),
                                    uv1=scene.uv1 * 2.0)
    want = JG.gbuffer_pass(tri, z, b0, b1, jscene, tiny.vs)
    got = G.gbuffer_pass(t(tri), t(z), t(b0), t(b1), scene, tiny.pvs)
    _close_gbuf(got, want, (("position", 1e-5), ("normal", 1e-4),
                            ("base_color", 1e-5), ("emissive", 1e-6),
                            ("orm", 1e-5), ("velocity", 1e-5)))


def test_shadow_map_and_factor_match_reference(tiny):
    """The shadow map from the vertex stage's light clip positions, and
    calculate_shadow's 9 Poisson taps on it."""
    cfg = tiny.cfg
    want_map, ovf = _shadow_map_from_clip(
        tiny.vs.shadow_clip, tiny.jscene, cfg=cfg,
        binned_cap=tiny.jr._binned_cap,
    )
    got_map, povf = shadow_map_from_clip(tiny.scene, cfg=cfg,
                                         binned_cap=tiny.jr._binned_cap,
                                         shadow_clip=tiny.pvs.shadow_clip)
    assert int(ovf) == 0 and povf == 0
    assert (n(want_map) < 1.0).mean() > 0.1
    np.testing.assert_allclose(n(got_map), n(want_map), atol=1e-6, rtol=0)

    _, (tri, z, b0, b1) = _j_full_raster(tiny)
    gb = JG.gbuffer_pass(tri, z, b0, b1, tiny.jscene, tiny.vs)
    lpv = tiny.params["light_proj_view"]
    want = n(JSh.calculate_shadow(gb.position, lpv, want_map))
    got = n(Sh.calculate_shadow(t(gb.position), t(lpv), got_map))
    same = (got == want).mean()
    print(f"shadow factor: {same:.4%} of pixels equal, "
          f"{(want < 1).mean():.3f} shadowed")
    assert (want < 1).mean() > 0.05
    assert same > 0.999
    np.testing.assert_allclose(got, want, atol=1.0 / 9 + 1e-6, rtol=0)


def _ibl_fields(m):
    def chain(c, key):
        return {key: np.asarray(c.data if key == "data" else c.rows),
                "sizes": c.sizes, "offsets": c.offsets}

    return interop.ibl_from_numpy({
        "environment_faces": np.asarray(m.environment_faces),
        "irradiance_faces": np.asarray(m.irradiance_faces),
        "specular_mips": chain(m.specular_mips, "data"),
        "brdf_lut": np.asarray(m.brdf_lut),
        "specular_quad": chain(m.specular_quad, "rows"),
        "specular_quad_merged": chain(m.specular_quad_merged, "rows"),
        "irradiance_sh9": np.asarray(m.irradiance_sh9),
    }, "cpu")


def test_shading_pass_matches_reference(tiny):
    """Same G-buffer, SSAO, shadow map, lights, camera and IBL maps."""
    cfg = tiny.cfg
    _, (tri, z, b0, b1) = _j_full_raster(tiny)
    gb = JG.gbuffer_pass(tri, z, b0, b1, tiny.jscene, tiny.vs)
    smap, _ = _shadow_map_from_clip(tiny.vs.shadow_clip, tiny.jscene,
                                    cfg=cfg, binned_cap=tiny.jr._binned_cap)
    rng = np.random.default_rng(9)
    ssao = rng.uniform(0.5, 1.0, size=z.shape).astype(np.float32)
    ibl = tiny.jr.ibl.maps()
    n_lights = int(tiny.jscene.num_lights)
    want = JSh.shading_pass(gb, jnp.asarray(ssao), smap, tiny.jscene.lights,
                            tiny.jscene.num_lights, tiny.params, ibl=ibl)
    got = Sh.shading_pass(_to_port_gbuf(gb), t(ssao), t(smap),
                          tiny.scene.lights, n_lights, tiny.p,
                          ibl=_ibl_fields(ibl))
    diff = np.abs(n(got) - n(want))
    print(f"colour: max |diff| {diff.max():.3g}, "
          f"{(diff > 1e-4).mean():.4%} > 1e-4")
    assert (diff > 1e-4).mean() < 0.001  # a shadow tap may flip
    np.testing.assert_allclose(n(got), n(want), atol=0.2, rtol=0)
    # each term on its own
    np.testing.assert_allclose(
        n(Sh.ibl_ambient(_to_port_gbuf(gb), tiny.p["eye_pos"],
                         _ibl_fields(ibl))),
        n(JSh.ibl_ambient(gb, tiny.params["eye_pos"], ibl)),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        n(Sh.skybox_color(*z.shape, tiny.p, t(ibl.environment_faces))),
        n(JSh.skybox_color(*z.shape, tiny.params, ibl.environment_faces)),
        atol=1e-5, rtol=0)


# --- K8: the megakernel ---------------------------------------------------------

def test_pack_raster_attr_columns_matches_reference():
    rng = np.random.default_rng(11)
    tri_attrs = rng.normal(size=(300, 40)).astype(np.float32)
    tri_attrs[:, V.TRI_HANDED] = rng.choice([-1.0, 0.0, 1.0], 300)
    pv = rng.normal(size=(4, 4)).astype(np.float32)
    want = n(JV.pack_raster_attr_columns(jnp.asarray(tri_attrs),
                                         jnp.asarray(pv)))
    rows = n(V.pack_raster_attr_rows(t(tri_attrs), t(pv)))
    assert rows.shape == (300, V.RA_ROW)
    assert (rows[:, V.RA_EXTRA_COLS:] == 0).all()
    got = rows[:, : V.RA_EXTRA_COLS]
    assert got.shape == want.shape == (300, V.RA_EXTRA_COLS)
    np.testing.assert_array_equal(got[:, 3:], want[:, 3:])
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=1e-5, atol=0)


def _megakernel_inputs(tiny_):
    """The JAX megakernel branch's rows (frame_graph.py:320-343)."""
    r, cfg = tiny_.jr, tiny_.cfg
    setup = JRS.triangle_setup(tiny_.vs.clip, tiny_.jscene.indices,
                               tiny_.jscene.tri_valid, r.pad_w, r.pad_h,
                               cull_backface=True)
    extra = JV.pack_raster_attr_columns(tiny_.jscene.tri_attrs,
                                        tiny_.params["proj_view"])
    setup = dataclasses.replace(
        setup, tri_data=jnp.concatenate([setup.tri_data, extra], axis=1))
    binned = JRS.bin_triangles(
        setup, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
        n_tiles_x=r.pad_w // cfg.tile_w, n_tiles_y=r.pad_h // cfg.tile_h,
        max_tiles_per_tri=8, binned_cap=r._binned_cap, global_cap=512,
    )
    want = j_rasterize_attrs(binned, width=r.pad_w, height=r.pad_h,
                             tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    port_binned, attr_rows = R.split_attr_rows(
        _port_bin(setup.tri_data, setup.bbox, r.pad_w, r.pad_h))
    got = R.rasterize_attrs(port_binned, width=r.pad_w, height=r.pad_h,
                            attr_rows=attr_rows)
    return want, got


def _assert_attrs_equal(got, want, what):
    tri_g, z_g, planes_g, mat_g, ht_g = got
    tri_w, z_w, planes_w, mat_w, ht_w = want
    cov = n(tri_w) >= 0
    print(f"{what}: {(n(tri_g) != n(tri_w)).sum()} id mismatches, covered "
          f"{cov.mean():.3f}")
    np.testing.assert_array_equal(n(tri_g), n(tri_w))
    np.testing.assert_array_equal(n(mat_g), n(mat_w))
    np.testing.assert_array_equal(n(ht_g), n(ht_w))
    np.testing.assert_allclose(n(z_g), n(z_w), atol=1e-6, rtol=0)
    assert len(planes_g) == len(planes_w) == V.RA_N_INTERP
    for i, (a, b) in enumerate(zip(planes_g, planes_w)):
        np.testing.assert_allclose(n(a), n(b), rtol=2e-3, atol=1e-4,
                                   err_msg=f"plane {i}")


def test_rasterize_attrs_matches_reference(tiny):
    want, got = _megakernel_inputs(tiny)
    _assert_attrs_equal(got, want, "megakernel, tiny scene")


def test_rasterize_attrs_matches_reference_on_a_soup():
    """Random triangles with random attribute columns (perspective w from
    random 1/w corners)."""
    clip, idx = _soup(13, 200)
    setup = JRS.triangle_setup(jnp.asarray(clip), jnp.asarray(idx),
                               jnp.ones(200, bool), W, H, cull_backface=False)
    rng = np.random.default_rng(13)
    extra = rng.normal(size=(200, V.RA_EXTRA_COLS)).astype(np.float32)
    extra[:, :3] = rng.uniform(0.2, 2.0, size=(200, 3))
    extra[:, -2] = rng.integers(0, 7, 200)
    extra[:, -1] = rng.integers(0, 2, 200)
    setup = dataclasses.replace(setup, tri_data=jnp.concatenate(
        [setup.tri_data, jnp.asarray(extra)], axis=1))
    binned = JRS.bin_triangles(
        setup, tile_h=16, tile_w=128, n_tiles_x=W // 128, n_tiles_y=H // 16,
        max_tiles_per_tri=8, binned_cap=1 << 16, global_cap=64,
    )
    want = j_rasterize_attrs(binned, width=W, height=H, tile_h=16,
                             tile_w=128)
    port_binned, attr_rows = R.split_attr_rows(
        _port_bin(setup.tri_data, setup.bbox, W, H))
    got = R.rasterize_attrs(port_binned, width=W, height=H,
                            attr_rows=attr_rows)
    _assert_attrs_equal(got, want, "megakernel, soup")


def test_gbuffer_pass_from_planes_matches_reference(tiny):
    (tri, z, planes, mat, ht), _ = _megakernel_inputs(tiny)
    want = JG.gbuffer_pass_from_planes(tri, z, planes, mat, ht, tiny.jscene,
                                       tiny.params,
                                       slot_map=tiny.jr._slot_map)
    got = G.gbuffer_pass_from_planes(
        t(tri), t(z), [t(p) for p in planes], t(mat), t(ht), tiny.scene,
        tiny.p, tiny.jr._slot_map,
    )
    _close_gbuf(got, want, (("position", 1e-6), ("normal", 1e-5),
                            ("base_color", 1e-6), ("emissive", 1e-6),
                            ("orm", 1e-6), ("velocity", 1e-5)))
