"""The fast path's option variants in the port against the JAX reference,
on the same inputs: the PCF table layouts (``pcf_u16``,
``pcf_half_anchor``) and the shadow factor each gives, every reachable
branch of the specular/sky sampler (``spec_parent_mip_half_res``,
``spec_mirror_half_res``, ``spec_merged_trilinear``, with and without
the checkerboard domain), the standalone ``skybox_color_fast``, SSAO without the tile kernel
(``ssao_pallas=False``: ``ssao_pass``, with ``ssao_pass_exact`` as the
oracle), and the whole ``shading_pass_fast`` (the CPU's side of the CUDA
kernel K9) under the option sets no frame test reaches: five lights of
all three kinds, each PCF layout and divisor on and off the
checkerboard, a band of a row-sharded frame, no IBL and no shadow.  The inputs are the tiny scene's own G-buffer, shadow map and
IBL maps, made by the JAX package and carried over as numpy.

Bars: PCF tables exact.  The shadow factor equal on > 99.9% of pixels
and within one tap elsewhere (``current > closest`` flips on one ulp, as
in tests/test_torch_vertex_path.py); the test prints the share that
differs.  Ambient and sky atol 1e-5 / rtol 1e-5 (float32 sums in another
order).  SSAO at the bar of tests/test_torch_ssao.py.  The shaded colour
at rtol 2e-3 / atol 1e-4 on > 99.5% of pixels, and within one PCF tap
(0.75 / 9 before the tonemap) elsewhere.
"""

import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mo_renderer_tpu.device import sampling as JSm  # noqa: E402
from mo_renderer_tpu.kernels import raster_setup as JRS  # noqa: E402
from mo_renderer_tpu.kernels.decimate import decimate_cols as j_decimate  # noqa: E402
from mo_renderer_tpu.kernels.rasterizer import rasterize as j_rasterize  # noqa: E402
from mo_renderer_tpu.passes import gbuffer as JG  # noqa: E402
from mo_renderer_tpu.passes import shading as JSh  # noqa: E402
from mo_renderer_tpu.passes import ssao as JS  # noqa: E402
from mo_renderer_tpu.passes.frame_graph import (  # noqa: E402
    Renderer as JRenderer,
    _shadow_map_from_clip,
    build_camera_params as j_camera_params,
)
from mo_renderer_tpu.scene.scene_buffers import find_shadow_light  # noqa: E402
from mo_renderer_tpu_torch import interop  # noqa: E402
from mo_renderer_tpu_torch.device import sampling as S  # noqa: E402
from mo_renderer_tpu_torch.passes import shading as Sh  # noqa: E402
from mo_renderer_tpu_torch.passes import ssao as SS  # noqa: E402
from mo_renderer_tpu_torch.passes.gbuffer import GBuffer  # noqa: E402

from test_torch_ssao import _assert_ssao_bar, _scene_depth, _synthetic_depth  # noqa: E402


def n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def ref():
    """The tiny scene's G-buffers (full-res and checkerboard), shadow
    map, camera block and IBL maps, from the JAX package."""
    cfg = graft._tiny_config()
    world = graft._tiny_world()
    cam = graft._camera(cfg)
    world.insert_resource(cam)
    r = JRenderer(cfg)
    r.prepare(world)
    light_pv, _ = find_shadow_light(world)
    params = j_camera_params(cam, light_pv)
    setup = JRS.triangle_setup_from_attrs(
        r.scene.tri_attrs, r.scene.tri_valid, params["proj_view"],
        r.pad_w, r.pad_h, cull_backface=True,
    )
    binned = JRS.bin_triangles(
        setup, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
        n_tiles_x=r.pad_w // cfg.tile_w, n_tiles_y=r.pad_h // cfg.tile_h,
        max_tiles_per_tri=8, binned_cap=r._binned_cap, global_cap=512,
    )
    tri, z, _, _ = j_rasterize(binned, width=r.pad_w, height=r.pad_h,
                               tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                               slim=True)
    gbufs = {}
    for cb in (False, True):
        tri_g, z_g = (j_decimate(tri, "cb"), j_decimate(z, "cb")) if cb \
            else (tri, z)
        gbufs[cb] = JG.gbuffer_pass_fast(
            tri_g, z_g, None, None, r.scene, r.scene.tri_attrs, params,
            slot_map=r._slot_map, cb=cb, full_wh=(r.pad_w, r.pad_h),
        )
    smap, _ = _shadow_map_from_clip(
        None, r.scene, cfg=cfg, binned_cap=r._binned_cap,
        light_pv=params["light_proj_view"],
    )
    m = r.ibl.maps()

    def chain(c, key):
        return {key: np.asarray(c.data if key == "data" else c.rows),
                "sizes": c.sizes, "offsets": c.offsets}

    port_ibl = interop.ibl_from_numpy({
        "environment_faces": np.asarray(m.environment_faces),
        "irradiance_faces": np.asarray(m.irradiance_faces),
        "specular_mips": chain(m.specular_mips, "data"),
        "brdf_lut": np.asarray(m.brdf_lut),
        "specular_quad": chain(m.specular_quad, "rows"),
        "specular_quad_merged": chain(m.specular_quad_merged, "rows"),
        "irradiance_sh9": np.asarray(m.irradiance_sh9),
    }, "cpu")
    basis = ("eye_pos", "direction", "right", "up", "near", "near_wh",
             "light_proj_view")
    return types.SimpleNamespace(
        cfg=cfg, gbufs=gbufs, smap=smap, params=params, ibl=m,
        port_ibl=port_ibl, port_params={k: t(params[k]) for k in basis},
        s=cfg.shadow_map_size,
    )


def _port_gbuf(gb):
    return GBuffer(*[t(getattr(gb, f)) for f in (
        "base_color", "position", "normal", "emissive", "orm", "velocity",
        "depth", "mask")])


BUILDERS = {
    "f32 2x4 rows": (JSm.build_window_rows_2x4, S.build_window_rows_2x4),
    "u16 windows": (JSm.build_pcf_window_u16, S.build_pcf_window_u16),
    "u16 half-anchor": (JSm.build_pcf_window_u16_half,
                        S.build_pcf_window_u16_half),
}


@pytest.mark.parametrize("layout", ["f32 2x4 rows", "u16 windows"])
def test_pcf_table_matches_reference(ref, layout):
    j_build, build = BUILDERS[layout]
    want = n(j_build(ref.smap))
    got = n(build(t(ref.smap)))
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", list(BUILDERS))
def test_calculate_shadow_fast_matches_reference(ref, layout):
    """Each layout's PCF factor on the same shadow map and positions."""
    j_build, build = BUILDERS[layout]
    pos = ref.gbufs[False].position
    lpv = ref.params["light_proj_view"]
    want = n(JSh.calculate_shadow_fast(pos, lpv, j_build(ref.smap), ref.s))
    got = n(Sh.calculate_shadow_fast(t(pos), t(lpv), build(t(ref.smap)),
                                     ref.s))
    same = (got == want).mean()
    print(f"{layout}: {1 - same:.4%} of pixels differ, "
          f"{(want < 1).mean():.3f} shadowed")
    assert (want < 1).mean() > 0.05
    assert same > 0.999
    np.testing.assert_allclose(got, want, atol=1.0 / 9 + 1e-6, rtol=0)


# (parent_mip_half_res, mirror_half_res, merged_trilinear, cb): every
# combination the reference runs (the full-rate mirror tap raises on the
# checkerboard domain)
SPEC_CASES = [
    (p, m, g, cb)
    for cb in (False, True) for m in (True, False) for p in (True, False)
    for g in (True, False) if m or not cb
]


@pytest.mark.parametrize("parent,mirror,merged,cb", SPEC_CASES)
def test_ibl_ambient_sky_fast_matches_reference(ref, parent, mirror, merged,
                                                cb):
    gb = ref.gbufs[cb]
    flags = dict(parent_mip_half_res=parent, mirror_half_res=mirror,
                 merged_trilinear=merged, cb=cb)
    want = JSh.ibl_ambient_sky_fast(gb, ref.params["eye_pos"], ref.ibl,
                                    ref.params, **flags)
    got = Sh.ibl_ambient_sky_fast(_port_gbuf(gb), ref.port_params["eye_pos"],
                                  ref.port_ibl, ref.port_params, **flags)
    sky = n(want[2])
    assert 0.05 < sky.mean() < 0.95
    np.testing.assert_array_equal(n(got[2]), sky)
    # ambient is garbage (and masked) at sky pixels; the sky only counts
    # there
    np.testing.assert_allclose(n(got[0])[~sky], n(want[0])[~sky],
                               atol=1e-5, rtol=1e-5, err_msg="ambient")
    np.testing.assert_allclose(n(got[1])[sky], n(want[1])[sky],
                               atol=1e-5, rtol=1e-5, err_msg="sky")


def test_full_rate_mirror_on_the_checkerboard_raises(ref):
    gb = ref.gbufs[True]
    with pytest.raises(NotImplementedError, match="spec_mirror_half_res"):
        JSh.ibl_ambient_sky_fast(gb, ref.params["eye_pos"], ref.ibl,
                                 ref.params, mirror_half_res=False, cb=True)
    with pytest.raises(NotImplementedError, match="spec_mirror_half_res"):
        Sh.ibl_ambient_sky_fast(_port_gbuf(gb), ref.port_params["eye_pos"],
                                ref.port_ibl, ref.port_params,
                                mirror_half_res=False, cb=True)


def test_skybox_color_fast_matches_reference(ref):
    """The standalone skybox from the quad-packed environment rows
    (shading.py:547) on a 64x32 frame: atol 1e-5 / rtol 1e-5, the sky's
    bar above."""
    want = n(JSh.skybox_color_fast(32, 64, ref.params, ref.ibl))
    got = n(Sh.skybox_color_fast(32, 64, ref.port_params, ref.port_ibl))
    assert got.shape == (32, 64, 3) and want.max() > 0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_ibl_ambient_fast_matches_reference(ref):
    gb = ref.gbufs[False]
    want = n(JSh.ibl_ambient_fast(gb, ref.params["eye_pos"], ref.ibl))
    got = n(Sh.ibl_ambient_fast(_port_gbuf(gb), ref.port_params["eye_pos"],
                                ref.port_ibl))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("h,w,seed,kind", [
    (64, 128, 5, "synthetic"), (64, 256, 1, "scene"), (96, 384, 2, "scene"),
])
def test_ssao_pass_matches_reference(h, w, seed, kind):
    """ssao_pass (ssao_pallas=False) against the reference's jitted
    ssao_pass on the same depth."""
    depth = (_synthetic_depth if kind == "synthetic" else _scene_depth)(
        h, w, seed
    )
    want = n(jax.jit(JS.ssao_pass)(jnp.asarray(depth)))
    got = n(SS.ssao_pass(t(depth)))
    assert want.min() < 0.99
    _assert_ssao_bar(got, want, f"ssao_pass {kind} {h}x{w}")


def test_ssao_pass_exact_matches_reference():
    """The tap-for-tap oracle against the reference's, and the
    radius-quantized pass against the oracle: both within the
    quantization's own error on the reference's side."""
    depth = _scene_depth(64, 256, 3)
    want = n(jax.jit(JS.ssao_pass_exact)(jnp.asarray(depth)))
    got = n(SS.ssao_pass_exact(t(depth)))
    _assert_ssao_bar(got, want, "ssao_pass_exact")
    ref_gap = np.abs(n(jax.jit(JS.ssao_pass)(jnp.asarray(depth))) - want)
    gap = np.abs(n(SS.ssao_pass(t(depth))) - got)
    print(f"quantized vs exact: mean {gap.mean() * 255:.3f}/255 "
          f"(reference {ref_gap.mean() * 255:.3f}/255)")
    assert abs(gap.mean() - ref_gap.mean()) < 0.1 / 255


def test_sample_mipcube_quad_lod_matches_reference(ref):
    rng = np.random.default_rng(3)
    dirs = rng.normal(size=(32, 64, 3)).astype(np.float32)
    lod = rng.uniform(-0.5, 3.5, size=(32, 64)).astype(np.float32)
    want = n(JSm.sample_mipcube_quad_lod(ref.ibl.specular_quad,
                                         jnp.asarray(dirs), jnp.asarray(lod)))
    got = n(S.sample_mipcube_quad_lod(ref.port_ibl.specular_quad, t(dirs),
                                      t(lod)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# light rows (scene_buffers.GPU_LIGHT_STRIDE columns): type, spot
# exponent, position, colour, direction, attenuation -- a directional, two
# point and two spot lights, as many as grid_world's five
_LIGHTS = [
    (0.0, 0.0, (0.0, 0.0, 0.0), (1.0, 0.95, 0.9), (-0.5, -1.0, -0.3),
     (3.0, 0.0, 0.0)),
    (1.0, 0.0, (1.0, 1.5, 1.0), (0.4, 0.7, 1.0), (0.0, 0.0, 0.0),
     (1.0, 0.2, 0.1)),
    (2.0, 8.0, (-1.0, 2.0, 0.5), (1.0, 0.6, 0.3), (0.4, -1.0, -0.2),
     (1.0, 0.05, 0.02)),
    (1.0, 0.0, (-2.0, 0.5, -1.5), (0.8, 0.8, 0.6), (0.0, 0.0, 0.0),
     (0.5, 0.0, 0.3)),
    (2.0, 30.0, (0.5, 3.0, -0.5), (0.9, 0.9, 1.0), (0.0, -1.0, 0.1),
     (1.0, 0.0, 0.0)),
]


def _light_rows(n_lights):
    rows = np.zeros((n_lights + 1, 20), np.float32)  # one padding row
    for i, (kind, spot, pos, col, d, att) in enumerate(_LIGHTS[:n_lights]):
        rows[i, 0], rows[i, 2] = kind, spot
        rows[i, 4:7], rows[i, 8:11], rows[i, 12:15] = pos, col, d
        rows[i, 16:19] = att
    return rows


BAND = (64, 256)  # a band case: its first row and the frame's height
_TABLES = {}


def _pcf_tables(ref, layout):
    """(JAX, port) PCF table of ``layout`` on the scene's shadow map, built
    once per layout."""
    if layout not in _TABLES:
        j_build, build = BUILDERS[layout]
        _TABLES[layout] = (j_build(ref.smap), build(t(ref.smap)))
    return _TABLES[layout]

# (cb, PCF layout, divisor, (parent, mirror, merged), n_lights, what)
SHADING_CASES = {
    "cb f32-rows div4 5-lights": (True, "f32 2x4 rows", 4,
                                  (True, True, True), 5, None),
    "cb u16-full div2": (True, "u16 windows", 2, (True, True, False), 1,
                         None),
    "cb u16-half div1 3-lights": (True, "u16 half-anchor", 1,
                                  (False, True, False), 3, None),
    "full u16-half div4 5-lights": (False, "u16 half-anchor", 4,
                                    (True, True, True), 5, None),
    "full f32-rows div2 full-rate taps": (False, "f32 2x4 rows", 2,
                                          (False, False, False), 2, None),
    "cb band": (True, "u16 half-anchor", 4, (True, True, True), 5, "band"),
    "full band full-rate mirror": (False, "u16 windows", 4,
                                   (True, False, False), 1, "band"),
    "cb no IBL": (True, "u16 half-anchor", 4, (True, True, True), 5,
                  "no ibl"),
    "full no shadow": (False, None, 4, (True, True, True), 5, "no shadow"),
}


@pytest.mark.parametrize("case", list(SHADING_CASES))
def test_shading_pass_fast_matches_reference(ref, case):
    cb, layout, divisor, (parent, mirror, merged), n_lights, what = \
        SHADING_CASES[case]
    # the whole G-buffer: the ops the tests above ran on it are compiled
    # already (a band case shades it as the rows of a taller frame)
    jgb = ref.gbufs[cb]
    ssao = np.random.default_rng(len(case)).uniform(
        0.6, 1.0, size=jgb.depth.shape).astype(np.float32)
    rows = None if layout is None else _pcf_tables(ref, layout)
    lights = _light_rows(n_lights)
    band = dict(row_offset=BAND[0], full_height=BAND[1]) if what == "band" \
        else {}
    use_ibl = what != "no ibl"
    flags = dict(shadow_res_divisor=divisor, parent_mip_half_res=parent,
                 mirror_half_res=mirror, merged_trilinear=merged, cb=cb,
                 **band)
    want = n(JSh.shading_pass_fast(
        jgb, jnp.asarray(ssao), None if rows is None else rows[0], ref.s,
        jnp.asarray(lights), n_lights, ref.params,
        ibl=ref.ibl if use_ibl else None, static_light_count=n_lights,
        **flags))
    got = n(Sh.shading_pass_fast(
        _port_gbuf(jgb), t(ssao), None if rows is None else rows[1], ref.s,
        t(lights), n_lights, ref.port_params,
        ibl=ref.port_ibl if use_ibl else None, **flags))
    assert got.shape == want.shape == tuple(jgb.depth.shape) + (3,)
    sky = n(jgb.depth) >= 1.0
    assert 0.02 < sky.mean() < 0.98  # sky and geometry both shaded
    close = np.isclose(got, want, rtol=2e-3, atol=1e-4).all(-1)
    print(f"{case}: {1 - close.mean():.3%} of pixels outside rtol 2e-3 / "
          f"atol 1e-4, max |diff| {np.abs(got - want).max():.3g}")
    assert close.mean() > 0.995
    np.testing.assert_allclose(got, want, atol=0.75 / 9, rtol=0)


def test_shading_cases_cover_every_option():
    """Between them the cases shade both domains, every PCF layout and
    divisor, each specular branch, 1-5 lights, a band, no IBL and no
    shadow."""
    cases = SHADING_CASES.values()
    assert {c[0] for c in cases} == {True, False}
    assert {c[1] for c in cases} == set(BUILDERS) | {None}
    assert {c[2] for c in cases} == {1, 2, 4}
    assert {c[3] for c in cases} >= {(True, True, True), (True, True, False),
                                     (False, True, False),
                                     (False, False, False),
                                     (True, False, False)}
    assert {c[4] for c in cases} >= {1, 5}
    assert {c[5] for c in cases} == {None, "band", "no ibl", "no shadow"}
