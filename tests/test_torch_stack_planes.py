"""The port's texture-stack path against the JAX reference: the
stack_planes kernel's plain version (K7, the JAX Pallas kernel in
interpret mode), its out_spec mapping, the fast G-buffer pass with the
stack kernel on and with the attrs kernel off, and the all-slots scene
that samples every slot of the 8/8/4 texture-stack groups.

Bars: K7 planes rtol/atol 1e-6 (tests/test_stack_planes.py:56-57);
G-buffer fields rtol 2e-3 / atol 1e-4 (tests/test_attr_planes.py:75-100);
the pack field by field, integers exact and floats within atol 1e-6.
"""

import dataclasses
import itertools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mo_renderer_tpu.assets.model import Model as JModel  # noqa: E402
from mo_renderer_tpu.kernels import raster_setup as JRS  # noqa: E402
from mo_renderer_tpu.kernels.decimate import decimate_cols as j_decimate  # noqa: E402
from mo_renderer_tpu.kernels.rasterizer import rasterize as j_rasterize  # noqa: E402
from mo_renderer_tpu.kernels.stack_planes import stack_planes as j_stack_planes  # noqa: E402
from mo_renderer_tpu.passes import gbuffer as JG  # noqa: E402
from mo_renderer_tpu.passes.frame_graph import (  # noqa: E402
    Renderer as JRenderer,
    build_camera_params as j_camera_params,
)
from mo_renderer_tpu.scene import scene_buffers as JSB  # noqa: E402
from mo_renderer_tpu_torch import scenes  # noqa: E402
from mo_renderer_tpu_torch.interop import scene_from_numpy  # noqa: E402
from mo_renderer_tpu_torch.kernels import stack_planes as SP  # noqa: E402
from mo_renderer_tpu_torch.passes import gbuffer as G  # noqa: E402
from mo_renderer_tpu_torch.passes.frame_graph import CameraParams  # noqa: E402
from mo_renderer_tpu_torch.scene import scene_buffers as SB  # noqa: E402


def _reference_spec(slot_map):
    """The mapping the reference's _texture_and_assemble builds inline
    (mo_renderer_tpu/passes/gbuffer.py:437-444): two slots per group."""
    spec = []
    for k, p in enumerate(slot_map):
        if p < 0:
            continue
        for c in SP.SLOT_CHANNELS[k]:
            spec.append((p // 2, 4 * (p % 2), 8 * c))
    return tuple(spec)


def _packed_widths(n_sampled):
    """Group widths scene packing gives n sampled slots (8/8/4 split)."""
    widths = [4 * min(2, n_sampled)]
    if n_sampled > 2:
        widths.append(4 * min(2, n_sampled - 2))
    if n_sampled > 4:
        widths.append(4)
    return widths


def _slot_map(sampled):
    m, pos = [-1] * 5, 0
    for k in range(5):
        if k in sampled:
            m[k], pos = pos, pos + 1
    return tuple(m)


@pytest.mark.parametrize("widths,sampled", [
    ([8], (0, 2)), ([8, 4], (0, 1, 3)), ([8, 8, 4], (0, 1, 2, 3, 4)),
])
def test_stack_planes_matches_reference_kernel(widths, sampled):
    rng = np.random.default_rng(11 + len(widths))
    h, w, n_rows = 16, 128, 300
    tables = [
        rng.integers(0, 1 << 32, size=(n_rows, gw), dtype=np.uint64)
        .astype(np.uint32) for gw in widths
    ]
    idx = rng.integers(0, n_rows, size=(h, w)).astype(np.int32)
    fx = rng.uniform(0, 1, size=(h, w)).astype(np.float32)
    fy = rng.uniform(0, 1, size=(h, w)).astype(np.float32)
    slot_map = _slot_map(sampled)
    spec, plane_of = SP.out_spec(slot_map, widths)
    assert spec == _reference_spec(slot_map)

    want = j_stack_planes(
        [jnp.asarray(t[idx]) for t in tables], jnp.asarray(fx),
        jnp.asarray(fy), out_spec=spec, block_rows=8, interpret=True,
    )
    got = SP.stack_planes(
        torch.from_numpy(idx), torch.from_numpy(fx), torch.from_numpy(fy),
        [torch.from_numpy(t.view(np.int32)) for t in tables], spec,
    )
    assert got.shape == (len(spec), h, w)
    assert sorted(plane_of.values()) == list(range(len(spec)))
    for i, ref in enumerate(want):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-6, err_msg=f"plane {i}")


def test_out_spec_matches_reference_for_every_packed_slot_set():
    """Derived from the packed group widths, the mapping equals the
    reference's p // 2, 4 * (p % 2) rule for every set of sampled slots
    scene packing can produce; the launcher groups each slot's channels
    into one quad."""
    for n in range(1, 6):
        for sampled in itertools.combinations(range(5), n):
            slot_map = _slot_map(sampled)
            spec, _ = SP.out_spec(slot_map, _packed_widths(n))
            assert spec == _reference_spec(slot_map), slot_map
            quads = SP._quad_table(spec)
            assert len(quads) == n
            assert sum(q[2] for q in quads) == len(spec)


def _all_slots_jax_world():
    world = graft._tiny_world()
    scenes.use_all_slots(next(iter(world.query(JModel))))
    return world


def test_all_slots_scene_packs_like_reference():
    """Every slot sampled: slot_map (0..4), groups 8/8/4 wide, 12 K7
    planes; the port's pack equals the reference's field by field."""
    ref = JSB.pack_scene(_all_slots_jax_world(), graft._tiny_config())
    port = SB.pack_scene(scenes.tiny_world(all_slots=True),
                         scenes.tiny_config(), "cpu")
    assert tuple(port.stack_slots.tolist()) == (0, 1, 2, 3, 4)
    widths = [port.texture_stack_a.shape[1], port.texture_stack_b.shape[1],
              port.texture_stack_c.shape[1]]
    assert widths == [8, 8, 4]
    assert len(SP.out_spec((0, 1, 2, 3, 4), widths)[0]) == 12
    assert port.tangent[:, 3].abs().max() == 1.0  # the cube has tangents
    for f in dataclasses.fields(ref):
        want = np.asarray(getattr(ref, f.name))
        got = getattr(port, f.name).numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.shape == want.shape, f.name
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f.name)


def _all_slots_visibility(cb):
    cfg = graft._tiny_config()
    world = _all_slots_jax_world()
    cam = graft._camera(cfg)
    world.insert_resource(cam)
    r = JRenderer(cfg)
    r.prepare(world)
    light_pv, _ = JSB.find_shadow_light(world)
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
    if cb:
        tri, z = j_decimate(tri, "cb"), j_decimate(z, "cb")
    return r, params, tri, z


def _gbuffers(cb, plane_kernel, stack_kernel):
    r, params, tri, z = _all_slots_visibility(cb)
    assert r._slot_map == (0, 1, 2, 3, 4)
    ref = JG.gbuffer_pass_fast(
        tri, z, None, None, r.scene, r.scene.tri_attrs, params,
        slot_map=r._slot_map, cb=cb, full_wh=(r.pad_w, r.pad_h),
        plane_kernel=plane_kernel, stack_kernel=stack_kernel,
    )
    scene = scene_from_numpy(
        {f.name: np.asarray(getattr(r.scene, f.name))
         for f in dataclasses.fields(r.scene)}, "cpu",
    )
    got = G.gbuffer_pass_fast(
        torch.from_numpy(np.asarray(tri)), torch.from_numpy(np.asarray(z)),
        scene, scene.tri_attrs, CameraParams(torch.from_numpy(
            np.asarray(params.vec))), r._slot_map, cb=cb,
        full_wh=(r.pad_w, r.pad_h), plane_kernel=plane_kernel,
        stack_kernel=stack_kernel,
    )
    return got, ref


def _assert_gbuffer_close(got, ref):
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(ref.depth))
    for field in ("position", "normal", "base_color", "emissive", "orm",
                  "velocity"):
        a, b = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
        print(f"{field}: max |diff| {np.abs(a - b).max():.3g}")
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-4,
                                   err_msg=field)


@pytest.mark.parametrize("cb,plane_kernel", [
    (True, True), (True, False), (False, False),
])
def test_gbuffer_stack_kernel_matches_reference(cb, plane_kernel):
    """stack_kernel=True, with the attrs kernel on and off: the port's
    K7 plain version vs the JAX Pallas kernel in the fast G-buffer."""
    got, ref = _gbuffers(cb, plane_kernel, stack_kernel=True)
    assert np.asarray(ref.emissive).max() > 0.05  # the emissive slot shows
    _assert_gbuffer_close(got, ref)


def test_gbuffer_attrs_kernel_off_matches_reference(monkeypatch):
    """attrs_plane_kernel=False runs the reference's non-kernel branch as
    torch ops (its own row gather, homogeneous barycentrics and the
    cross-product bitangent), never the attr_planes wrapper."""
    def no_kernel(*args, **kw):
        raise AssertionError("attr_planes called with the kernel off")

    monkeypatch.setattr(G, "attr_planes", no_kernel)
    got, ref = _gbuffers(cb=True, plane_kernel=False, stack_kernel=False)
    # the cube's tangents make the bitangent and the normal map count
    assert np.abs(np.asarray(ref.normal)[..., 0]).max() > 0.1
    _assert_gbuffer_close(got, ref)
