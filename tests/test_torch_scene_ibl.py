"""The port's scene packing and IBL precompute against the JAX reference's,
and the carry-over of both states (mo_renderer_tpu_torch/interop.py).

Each side packs a world built with its own package's builders (the port
has its own World, Model and components); the outputs are compared.

Bars: pack_scene field by field — integers exact, floats within atol
1e-6.  IBL maps at stated tolerances (see test_ibl_maps_match_reference).
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mo_renderer_tpu.device import sampling as JSm  # noqa: E402
from mo_renderer_tpu.scene import scene_buffers as JSB  # noqa: E402
from mo_renderer_tpu_torch import interop, scenes  # noqa: E402
from mo_renderer_tpu_torch.device import sampling as S  # noqa: E402
from mo_renderer_tpu_torch.scene import scene_buffers as SB  # noqa: E402

# each side's builders: (tiny world, procedural_model, Transform, lights)
SIDES = {"jax": "mo_renderer_tpu", "port": "mo_renderer_tpu_torch"}


def _api(side):
    import importlib

    pkg = SIDES[side]
    comp = importlib.import_module(pkg + ".scene.components")
    return (
        graft._tiny_world if side == "jax" else scenes.tiny_world,
        importlib.import_module(pkg + ".assets.procedural").procedural_model,
        importlib.import_module(pkg + ".math.transform").Transform,
        comp,
    )


def _tiny_world(side):
    return _api(side)[0]()


def _busy_world(side):
    """More entities, materials, textured slots and light types than the
    tiny scene: exercises stack entries, constant slots and light rows."""
    tiny, procedural_model, Transform, comp = _api(side)
    world = tiny()
    for i in range(3):
        world.spawn((
            Transform.from_xyz(-1.0 - i, 0.25 * i, 0.5),
            procedural_model("sphere", mr_gradient=True, textured=bool(i % 2),
                             base_color=(0.2, 0.4 + 0.1 * i, 0.9, 1.0)),
        ))
    world.spawn((comp.PointLight(Transform.from_xyz(0.0, 2.0, 1.0),
                                 (1.0, 0.8, 0.6), 3.0),))
    world.spawn((comp.SpotLight(Transform.from_xyz(1.0, 3.0, 0.0)
                                .looking_at((0.0, 0.0, 0.0)), exponent=4.0),))
    return world


def _jax_fields(scene):
    return {f.name: np.asarray(getattr(scene, f.name))
            for f in dataclasses.fields(scene)}


def _assert_fields_equal(port, ref_fields):
    for name, ref in ref_fields.items():
        got = getattr(port, name).cpu().numpy()
        if ref.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.shape == ref.shape, name
        if np.issubdtype(ref.dtype, np.floating):
            np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0,
                                       err_msg=name)
        else:
            assert got.dtype == ref.dtype, (name, got.dtype, ref.dtype)
            np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.mark.parametrize("make_world", [_tiny_world, _busy_world])
def test_pack_scene_matches_reference(make_world):
    ref = JSB.pack_scene(make_world("jax"), graft._tiny_config())
    port = SB.pack_scene(make_world("port"), scenes.tiny_config(), "cpu")
    _assert_fields_equal(port, _jax_fields(ref))


def _move_two(world, side):
    _, procedural_model, Transform, _ = _api(side)
    for transform, _model in list(world.query(Transform,
                                              type(procedural_model())))[:2]:
        transform.translation = transform.translation + np.float32(0.3)


def test_refresh_transforms_matches_reference():
    jworld, world = _busy_world("jax"), _busy_world("port")
    ref = JSB.pack_scene(jworld, graft._tiny_config())
    port = SB.pack_scene(world, scenes.tiny_config(), "cpu")
    assert SB.refresh_transforms(port) is port  # nothing moved
    _move_two(jworld, "jax")
    _move_two(world, "port")
    ref = JSB.refresh_transforms(ref)
    port = SB.refresh_transforms(port)
    _assert_fields_equal(port, _jax_fields(ref))


def test_find_shadow_light_matches_reference():
    pv_r, ok_r = JSB.find_shadow_light(_busy_world("jax"))
    world = _busy_world("port")
    pv, ok = SB.find_shadow_light(world)
    assert ok == ok_r
    np.testing.assert_array_equal(pv, pv_r)
    world2 = type(world)()
    world2.spawn((_api("port")[3].DirectionalLight(),))
    assert SB.find_shadow_light(world2)[1] is False


def test_scene_from_numpy_carries_the_reference_state():
    cfg = graft._tiny_config()
    ref = JSB.pack_scene(graft._tiny_world(), cfg)
    fields = _jax_fields(ref)
    _assert_fields_equal(interop.scene_from_numpy(fields, "cpu"), fields)


def _jax_ibl_fields(m):
    def chain(c, key):
        return {key: np.asarray(getattr(c, "data" if key == "data" else
                                        "rows")),
                "sizes": np.asarray(c.sizes), "offsets": np.asarray(c.offsets)}

    return {
        "environment_faces": np.asarray(m.environment_faces),
        "irradiance_faces": np.asarray(m.irradiance_faces),
        "specular_mips": chain(m.specular_mips, "data"),
        "brdf_lut": np.asarray(m.brdf_lut),
        "specular_quad": chain(m.specular_quad, "rows"),
        "specular_quad_merged": chain(m.specular_quad_merged, "rows"),
        "irradiance_sh9": np.asarray(m.irradiance_sh9),
    }


def test_ibl_maps_match_reference():
    """The tiny scene's IBL (16^2 cube, 3 specular mips, 8 samples).

    Tolerances, with their reasons:
    - environment, irradiance, BRDF LUT, SH9: float summation order only
      (1e-6 / 1e-5 / 1e-4 / 1e-5 absolute on values of order 1);
    - specular mips 1..: the prefilter samples an RGBE-packed source chain
      (8-bit shared-exponent mantissas).  A float difference that crosses
      a quantization boundary moves one tap by one mantissa step (0.4% to
      0.8%), so the mips are held to 1% of the map's peak;
    - RGBE quad rows (compared after unpacking): one mantissa step at
      most; identical on at least 99.5% of the specular_quad rows and
      97% of the merged rows (each repeats a parent quad up to 4 times,
      so one differing parent texel counts up to 4 times there).
    """
    ref = graft._tiny_ibl().maps()
    port = scenes.tiny_ibl(device="cpu").maps()

    def close(got, want, atol, what):
        got, want = got.numpy(), np.asarray(want)
        err = np.abs(got - want).max()
        print(f"{what}: max |diff| {err:.3g}")
        np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                   err_msg=what)

    close(port.environment_faces, ref.environment_faces, 1e-6, "environment")
    close(port.irradiance_faces, ref.irradiance_faces, 1e-5, "irradiance")
    close(port.brdf_lut, ref.brdf_lut, 1e-4, "brdf_lut")
    close(port.irradiance_sh9, ref.irradiance_sh9, 1e-5, "sh9")
    peak = float(np.abs(np.asarray(ref.specular_mips.data)).max())
    close(port.specular_mips.data, ref.specular_mips.data, 0.01 * peak,
          "specular mips")
    np.testing.assert_array_equal(port.specular_mips.sizes,
                                  ref.specular_mips.sizes)
    np.testing.assert_array_equal(port.specular_mips.offsets,
                                  ref.specular_mips.offsets)
    for name, share in (("specular_quad", 0.995),
                        ("specular_quad_merged", 0.97)):
        rows_p = getattr(port, name).rows
        rows_r = np.asarray(getattr(ref, name).rows)
        same = (rows_p.numpy().view(np.uint32) == rows_r).all(-1).mean()
        got = S.unpack_rgbe(rows_p).numpy()
        want = np.asarray(JSm.unpack_rgbe(jnp.asarray(rows_r)))
        step = 2.0 ** (np.ceil(np.log2(peak)) - 8)
        print(f"{name}: {same:.4%} rows identical")
        assert same > share
        np.testing.assert_allclose(got, want, atol=step, rtol=0)


def test_rgbe_pack_matches_reference():
    rng = np.random.default_rng(3)
    rgb = np.abs(rng.normal(size=(4096, 3))).astype(np.float32) * 10
    rgb[:4] = [[0, 0, 0], [1e-30, 0, 0], [255.0, 1.0, 0.5], [2.0, 2.0, 2.0]]
    want = np.asarray(JSm.pack_rgbe(jnp.asarray(rgb)))
    got = S.pack_rgbe(torch.from_numpy(rgb)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    # the reference's exp2 is off by an ulp or two for some exponents;
    # the port's power of two is exact
    np.testing.assert_allclose(
        S.unpack_rgbe(torch.from_numpy(want.view(np.int32))).numpy(),
        np.asarray(JSm.unpack_rgbe(jnp.asarray(want))), rtol=1e-6, atol=0,
    )


def test_pcf_window_table_matches_reference():
    rng = np.random.default_rng(4)
    img = rng.uniform(-0.1, 1.1, (64, 64)).astype(np.float32)
    want = np.asarray(JSm.build_pcf_window_u16_half(jnp.asarray(img)))
    got = S.build_pcf_window_u16_half(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)


def test_ibl_from_numpy_carries_the_reference_state():
    ref = graft._tiny_ibl().maps()
    fields = _jax_ibl_fields(ref)
    maps = interop.ibl_from_numpy(fields, "cpu")
    np.testing.assert_array_equal(maps.environment_faces.numpy(),
                                  fields["environment_faces"])
    np.testing.assert_array_equal(
        maps.specular_quad_merged.rows.numpy().view(np.uint32),
        fields["specular_quad_merged"]["rows"],
    )
    np.testing.assert_array_equal(maps.specular_mips.sizes,
                                  fields["specular_mips"]["sizes"])
