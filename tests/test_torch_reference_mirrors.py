"""The invariants of four reference tests, asserted on the PyTorch port
alone (no JAX frame): each test below names the reference test it
mirrors and holds the port's own frames to that test's own bars.

- ``tests/test_ortho_camera.py``: an orthographic camera does not
  foreshorten (equal extents, the configured scale), a perspective one
  does, and the depth test orders surfaces under the orthographic one.
- ``tests/test_end_to_end.py::test_flat_mode_no_ibl``: without an
  ``IBLResource`` the frame is direct light only on a black background.
  The reference renders ``monkey.glb``, which the repository does not
  hold; the port renders ``scenes.tiny_world``.
- ``tests/test_native_res_textures.py``: texture-stack entries keep their
  source size, mixed sizes share one table, and a 256^2 checker keeps its
  contrast through a 64^2 ``texture_array_size``.
- ``tests/test_fast_budget.py``: every knob set of the fast path
  (``scenes.BUDGET_BOUNDS``) against the port's own full-rate frame on
  ``scenes.budget_world``, within the reference's bounds.

All frames are 256x128 on the CPU.
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mo_renderer_tpu_torch import Renderer, scenes  # noqa: E402
from mo_renderer_tpu_torch.assets import materials as M  # noqa: E402
from mo_renderer_tpu_torch.assets.ibl_resource import IBLResource  # noqa: E402
from mo_renderer_tpu_torch.assets.materials import GltfMaterialCPU  # noqa: E402
from mo_renderer_tpu_torch.assets.model import Mesh, Model  # noqa: E402
from mo_renderer_tpu_torch.assets.procedural import (  # noqa: E402
    _checker_texture,
    plane_primitive,
    procedural_model,
)
from mo_renderer_tpu_torch.config import EngineConfig  # noqa: E402
from mo_renderer_tpu_torch.math.transform import Transform  # noqa: E402
from mo_renderer_tpu_torch.passes.frame_graph import (  # noqa: E402
    build_camera_params,
    frame_program,
)
from mo_renderer_tpu_torch.passes.present import unpack_rgba8  # noqa: E402
from mo_renderer_tpu_torch.scene.camera import Camera, CameraSettings  # noqa: E402
from mo_renderer_tpu_torch.scene.components import DirectionalLight  # noqa: E402
from mo_renderer_tpu_torch.scene.scene_buffers import (  # noqa: E402
    find_shadow_light,
    pack_scene,
)
from mo_renderer_tpu_torch.scene.world import World  # noqa: E402

W, H = 256, 128


def _render(cfg, world):
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    return r, r.render(world)


# --- tests/test_ortho_camera.py ------------------------------------------------

def _ortho_world():
    world = World()
    world.spawn((Transform.from_xyz(-0.5, 0.0, 2.0),
                 procedural_model("cube", size=0.6)))
    world.spawn((Transform.from_xyz(0.5, 0.0, 8.0),
                 procedural_model("cube", size=0.6)))
    world.spawn((DirectionalLight(
        Transform.from_xyz(3.0, 8.0, -2.0).looking_at((0.0, 0.0, 4.0)),
        (1.0, 1.0, 1.0), 4.0, True,
    ),))
    return world


def _ortho_camera(kind):
    cam = Camera(position=(0.0, 0.0, -4.0))
    if kind == "orthographic":
        cam.settings = CameraSettings("orthographic", height=4.0, near=0.1,
                                      far=100.0)
    cam.resize((W, H))
    return cam


def _ortho_config():
    return EngineConfig(width=W, height=H, shadow_map_size=256,
                        ssao_enabled=False)


def _cube_extents(frame):
    """(width_px, height_px) of the lit silhouette in each half-frame."""
    lit = frame[..., :3].sum(-1) > 0
    out = []
    for half in (lit[:, : W // 2], lit[:, W // 2:]):
        ys, xs = np.nonzero(half)
        assert len(xs) > 0, "cube not visible"
        out.append((xs.max() - xs.min() + 1, ys.max() - ys.min() + 1))
    return out


@pytest.mark.parametrize("kind", ["orthographic", "perspective"])
def test_camera_projection_extents(kind):
    """test_ortho_camera.py: equal extents and ~19 px under the
    orthographic camera; the far cube under 3/4 of the near one's size
    under the perspective camera."""
    world = _ortho_world()
    world.insert_resource(_ortho_camera(kind))
    _, frame = _render(_ortho_config(), world)
    assert frame.shape == (H, W, 4)
    (wa, ha), (wb, hb) = _cube_extents(frame)
    if kind == "orthographic":
        assert abs(wa - wb) <= 2 and abs(ha - hb) <= 2, (wa, wb, ha, hb)
        assert 15 <= ha <= 24, ha
    else:
        assert min(wa, wb) < 0.75 * max(wa, wb), (wa, wb)
        assert min(ha, hb) < 0.75 * max(ha, hb), (ha, hb)


def test_orthographic_depth_order():
    """test_ortho_camera.py: the closer (red) cube wins the centre."""
    world = World()
    world.spawn((Transform.from_xyz(0.0, 0.0, 3.0), procedural_model(
        "cube", size=0.6, base_color=(1.0, 0.0, 0.0, 1.0))))
    world.spawn((Transform.from_xyz(0.0, 0.0, 6.0), procedural_model(
        "cube", size=1.2, base_color=(0.0, 0.0, 1.0, 1.0))))
    world.spawn((DirectionalLight(
        Transform.from_xyz(0.0, 2.0, -6.0).looking_at((0.0, 0.0, 3.0)),
        (1.0, 1.0, 1.0), 4.0, True,
    ),))
    world.insert_resource(_ortho_camera("orthographic"))
    _, frame = _render(_ortho_config(), world)
    center = frame[H // 2 - 4: H // 2 + 4, W // 2 - 4: W // 2 + 4, :3]
    assert center[..., 0].mean() > center[..., 2].mean()


# --- tests/test_end_to_end.py::test_flat_mode_no_ibl ------------------------------

def test_flat_mode_no_ibl():
    """No IBLResource: direct light only, a black corner, a lit model."""
    cfg = scenes.tiny_config(ssao_enabled=False)
    world = scenes.tiny_world()
    world._resources.pop(IBLResource, None)
    world.insert_resource(scenes.camera(cfg))
    r, frame = _render(cfg, world)
    assert r.ibl is None
    assert frame[0:4, 0:4, :3].max() == 0
    assert frame[..., :3].max() > 30


# --- tests/test_native_res_textures.py -----------------------------------------

def _checker_plane_world(tex_size, cells):
    world = World()
    mat = GltfMaterialCPU()
    mat.base_color_texture = 0
    model = Model(
        meshes=[Mesh(primitive=plane_primitive(size=8.0), material=mat)],
        textures=[_checker_texture(size=tex_size, cells=cells)],
    )
    world.spawn((Transform.from_xyz(0.0, 0.0, 0.0), model))
    world.spawn((DirectionalLight(
        Transform.from_xyz(5.0, 8.0, 5.0).looking_at((0.0, 0.0, 0.0)),
        (1.0, 1.0, 1.0), 4.0, True,
    ),))
    world.insert_resource(scenes.tiny_ibl())
    return world


def test_stack_entries_keep_native_size():
    """A 256^2 texture keeps a 256^2 entry under a 64^2 array size; a
    128^2 one and an untextured material's 4^2 floor share one table at
    cumulative bases."""
    cfg = scenes.tiny_config()
    scene = pack_scene(_checker_plane_world(256, 32), cfg, "cpu")
    mats = scene.materials.numpy()
    assert mats[0, M.MAT_STACK_SIZE] == 256.0
    assert mats[0, M.MAT_STACK_BASE] == 0.0
    assert scene.texture_stack_a.shape[0] >= 256 * 256

    world = _checker_plane_world(128, 16)
    world.spawn((Transform.from_xyz(0.0, 0.5, 0.0), procedural_model(
        "cube", base_color=(1.0, 0.2, 0.2, 1.0))))
    mats = pack_scene(world, cfg, "cpu").materials.numpy()
    sizes, bases = mats[:2, M.MAT_STACK_SIZE], mats[:2, M.MAT_STACK_BASE]
    assert set(sizes) == {128.0, 4.0}
    order = np.argsort(bases)
    assert bases[order[0]] == 0.0
    assert bases[order[1]] == sizes[order[0]] ** 2


def test_native_detail_survives_small_array_size():
    """The 64-cell checker's horizontal contrast on the bottom rows stays
    above 40 through a 64^2 texture_array_size."""
    cfg = scenes.tiny_config(ssao_enabled=False)
    world = _checker_plane_world(256, 64)
    world.insert_resource(scenes.camera(cfg))
    r, frame = _render(cfg, world)
    assert r._fast
    strip = frame[-20:, :, :3].astype(np.float32).mean(-1)
    contrast = np.abs(np.diff(strip, axis=1)).max()
    assert contrast > 40.0, contrast


# --- tests/test_fast_budget.py --------------------------------------------------

@pytest.fixture(scope="module")
def budget():
    """Each knob set's frame and the full-rate frame on budget_world, from
    one prepared scene (frame_program with each config)."""
    cfg = scenes.tiny_config(checkerboard=False, ssao_res_divisor=1)
    world = scenes.budget_world()
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    light_pv, _ = find_shadow_light(world)
    params = build_camera_params(scenes.camera(cfg), light_pv, "cpu")
    ibl = r.ibl.maps()

    def render(knobs):
        rgba, _ = frame_program(
            r.scene, ibl, params, cfg=scenes.budget_config(cfg, knobs),
            pad_w=r.pad_w, pad_h=r.pad_h, binned_cap=r._binned_cap,
            has_shadow_light=True, slot_map=r._slot_map,
            n_lights=r._n_lights, fast=True)
        return unpack_rgba8(rgba[:H, :W]).astype(np.int32)

    frames = {k: render(k) for k in scenes.BUDGET_BOUNDS}
    return frames, render(scenes.BUDGET_ORACLE)


@pytest.mark.parametrize("knobs", sorted(scenes.BUDGET_BOUNDS))
def test_fast_approximation_budget(budget, knobs):
    frames, oracle = budget
    mean_bound, frac_bound = scenes.BUDGET_BOUNDS[knobs]
    diff = np.abs(frames[knobs] - oracle)[..., :3]
    assert diff.mean() < mean_bound, (knobs, diff.mean())
    assert (diff > 12).mean() < frac_bound, (knobs, (diff > 12).mean())


def test_budget_scene_has_a_shadow_edge(budget):
    """The full-rate frame holds a shadowed region, so the PCF bounds are
    not vacuous."""
    _, oracle = budget
    assert oracle.shape == (H, W, 4)
    assert oracle[..., :3].mean(-1).std() > 10.0


def test_budget_config_maps_the_knobs():
    """budget_config fills the reference's defaults for a short knob set
    and takes a long one field by field."""
    base = scenes.tiny_config(checkerboard=False, ssao_res_divisor=1)
    c = scenes.budget_config(base, (2, False, True))
    assert (c.pcf_res_divisor, c.spec_parent_mip_half_res,
            c.spec_mirror_half_res, c.spec_merged_trilinear, c.checkerboard,
            c.ssao_res_divisor, c.pcf_half_anchor) == (
        2, False, True, False, False, 1, False)
    c = scenes.budget_config(base, (4, True, True, True, True, 2, True))
    assert dataclasses.astuple(c) == dataclasses.astuple(
        dataclasses.replace(
            base, pcf_res_divisor=4, spec_parent_mip_half_res=True,
            spec_mirror_half_res=True, spec_merged_trilinear=True,
            checkerboard=True, ssao_res_divisor=2, pcf_half_anchor=True))
