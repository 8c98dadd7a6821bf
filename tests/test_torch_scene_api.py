"""The port's own copies of the JAX package's jax-free scene API
(``mo_renderer_tpu_torch/{config,math,scene,assets}``) against the
originals: the same calls give the same arrays and the same defaults.

Bar: exact equality (both sides are the same numpy code).
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mo_renderer_tpu import config as JC  # noqa: E402
from mo_renderer_tpu.assets import procedural as JP  # noqa: E402
from mo_renderer_tpu.math import quat as JQ  # noqa: E402
from mo_renderer_tpu.math.transform import Transform as JTransform  # noqa: E402
from mo_renderer_tpu.scene import components as JComp  # noqa: E402
from mo_renderer_tpu_torch import config as C  # noqa: E402
from mo_renderer_tpu_torch import scenes  # noqa: E402
from mo_renderer_tpu_torch.assets import procedural as P  # noqa: E402
from mo_renderer_tpu_torch.math import quat as Q  # noqa: E402
from mo_renderer_tpu_torch.math.transform import Transform  # noqa: E402
from mo_renderer_tpu_torch.scene import components as Comp  # noqa: E402


def test_engine_config_defaults_equal():
    got, want = dataclasses.asdict(C.EngineConfig()), dataclasses.asdict(
        JC.EngineConfig())
    got.pop("resource_root")  # each package finds its own asset tree
    want.pop("resource_root")
    assert got == want
    for kw in (dict(width=256, height=128), dict(width=1280, height=720),
               dict(width=1920, height=1080, tile_h=32)):
        a, b = C.EngineConfig(**kw), JC.EngineConfig(**kw)
        assert (a.tile_h, a.raster_sub_y, a.raster_sub_x) == (
            b.tile_h, b.raster_sub_y, b.raster_sub_x)
    tiny, jtiny = (dataclasses.asdict(c) for c in (scenes.tiny_config(),
                                                   graft._tiny_config()))
    tiny.pop("resource_root")
    jtiny.pop("resource_root")
    assert tiny == jtiny


@pytest.mark.parametrize("angle", [0.0, 0.7, -2.1])
def test_camera_matrices_equal(angle):
    cfg = scenes.tiny_config()
    cam, jcam = scenes.camera(cfg, angle), graft._camera(cfg, angle)
    for name in ("view", "projection", "prev_view", "position", "direction",
                 "right", "up"):
        np.testing.assert_array_equal(getattr(cam, name)(),
                                      getattr(jcam, name)(), err_msg=name)
    assert (cam.near_p(), cam.fov(), cam.aspect()) == (
        jcam.near_p(), jcam.fov(), jcam.aspect())


def test_transform_equal():
    def build(T, q):
        t = T.from_xyz(1.0, -2.0, 0.5).looking_at((0.0, 0.3, 0.0))
        t.rotation = q.mul(t.rotation, q.from_rotation_y(0.4))
        t.scale = np.array([1.5, 0.5, 2.0], np.float32)
        return t

    a, b = build(Transform, Q), build(JTransform, JQ)
    np.testing.assert_array_equal(a.model_matrix(), b.model_matrix())
    np.testing.assert_array_equal(a.rotation, b.rotation)
    light = Comp.DirectionalLight(a, (1.0, 0.9, 0.8), 3.0, True)
    jlight = JComp.DirectionalLight(b, (1.0, 0.9, 0.8), 3.0, True)
    np.testing.assert_array_equal(light.proj_view(), jlight.proj_view())
    np.testing.assert_array_equal(light.gpu_light(), jlight.gpu_light())


@pytest.mark.parametrize("kind,kw", [
    ("cube", dict(textured=True)), ("sphere", dict(mr_gradient=True)),
    ("plane", dict(size=8.0)),
])
def test_procedural_model_arrays_equal(kind, kw):
    m, jm = P.procedural_model(kind, **kw), JP.procedural_model(kind, **kw)
    prim, jprim = m.meshes[0].primitive, jm.meshes[0].primitive
    for name in ("indices", "position", "normal", "color", "uv0", "uv1",
                 "tangent"):
        np.testing.assert_array_equal(getattr(prim, name),
                                      getattr(jprim, name), err_msg=name)
    for a, b in zip(m.textures, jm.textures):
        np.testing.assert_array_equal(a, b)
    assert len(m.textures) == len(jm.textures)
    assert dataclasses.asdict(m.meshes[0].material).keys() == (
        dataclasses.asdict(jm.meshes[0].material).keys())
    for k, v in dataclasses.asdict(m.meshes[0].material).items():
        np.testing.assert_array_equal(
            v, dataclasses.asdict(jm.meshes[0].material)[k], err_msg=k)


def test_window_descriptor_defaults_equal():
    """The window shell's descriptors (app/window.py) keep the reference's
    fields and defaults; both modules import without pygame."""
    from mo_renderer_tpu.app import window as JW
    from mo_renderer_tpu_torch.app import window as W

    for name in ("WindowResizeConstraints", "WindowDescriptor"):
        got, want = getattr(W, name)(), getattr(JW, name)()
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        if name == "WindowDescriptor":
            assert got.pop("mode").value == want.pop("mode").value
        assert got == want, name
    assert [m.value for m in W.WindowMode] == [m.value for m in JW.WindowMode]
    for w, h in ((64, 32), (1000, 50), (100, 5000)):
        c = dict(min_width=400.0, max_width=200.0, min_height=-5.0,
                 max_height=300.0)
        assert (W.WindowResizeConstraints(**c).clamp(w, h)
                == JW.WindowResizeConstraints(**c).clamp(w, h))
