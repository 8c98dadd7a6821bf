"""The asset-free scene the reference benchmarks and its goldens use
(``__graft_entry__._tiny_world`` / ``_tiny_config`` / ``_camera``),
rebuilt with the port's own classes: a textured cube, a metallic sphere,
a ground plane, one shadow-casting directional light and a synthetic
gradient sky, with the same entities and parameters.  Its UV1 variant
samples the cube's base colour with UV set 1, which sends the frame down
the reference sampling path; its all-slots variant gives the cube
textures in all five material slots (and tangents), so the fast path
samples every slot of the texture stacks.

``grid_world`` is the second asset-free scene, the reference's
"sponza-class" stress scene (``examples/sponza_scale.py``): a grid of
cubes and spheres with distinct materials on a textured plane, about 52K
triangles at the default 10 x 10 grid, which loads the rasterizer and the
binning where the tiny scene does not.

``lit_camera`` and ``tiny_lit_camera`` look down on ``grid_world``'s and
``tiny_world``'s planes so that every pixel is geometry: the frames with
no sky, on which every camera-dependent kernel is held.

``budget_world`` is the reference's error-budget stress scene
(``tests/test_fast_budget.py`` ``_stress_world``): hard shadow edges and a
roughness 0 -> 1 gradient sphere, on which every knob set of the fast
path (``BUDGET_BOUNDS``, ``budget_config``) is held to the full-rate
frame.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .assets.ibl_resource import IBLResource
from .assets.materials import DEFAULT_TEXTURE_MAP
from .assets.procedural import (  # noqa: F401 (synthetic_sky: scenes API)
    _mr_gradient_texture,
    procedural_model,
    synthetic_sky,
)
from .config import EngineConfig
from .examples import sponza_scale
from .math import quat
from .math.transform import Transform
from .scene.camera import Camera
from .scene.components import DirectionalLight
from .scene.world import World


def tiny_config(**overrides):
    """The reference's 256x128 golden configuration."""
    kw = dict(width=256, height=128, shadow_map_size=256,
              texture_array_size=64, tile_h=16, tile_w=128, max_lights=16)
    kw.update(overrides)
    return EngineConfig(**kw)


def tiny_ibl(device=None) -> IBLResource:
    return IBLResource.from_equirect(
        synthetic_sky(), cubemap_size=16, irradiance_size=8,
        specular_mips=3, specular_samples=8, brdf_lut_size=16, device=device,
    )


def use_uv1(model) -> None:
    """Make ``model``'s first mesh sample its base colour with UV set 1,
    set to twice UV set 0 (the checker tiles twice as often)."""
    mesh = model.meshes[0]
    mesh.material.base_color_uv = 1
    mesh.primitive.uv1 = (mesh.primitive.uv0 * 2.0).astype(np.float32)


def _tangents(prim) -> np.ndarray:
    """(N, 4) per-vertex tangents from the triangles' uv gradients, w the
    handedness of the uv frame against the normal."""
    tri = prim.indices.reshape(-1, 3).astype(np.int64)
    p = prim.position[:, :3][tri]
    uv = prim.uv0[tri]
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    d1, d2 = uv[:, 1] - uv[:, 0], uv[:, 2] - uv[:, 0]
    det = (d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1])[:, None]
    t_face = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) / det
    b_face = (e2 * d1[:, 0:1] - e1 * d2[:, 0:1]) / det
    n = prim.normal[:, :3].astype(np.float64)
    t = np.zeros_like(n)
    b = np.zeros_like(n)
    np.add.at(t, tri.reshape(-1), np.repeat(t_face, 3, axis=0))
    np.add.at(b, tri.reshape(-1), np.repeat(b_face, 3, axis=0))
    t = t - n * (t * n).sum(-1, keepdims=True)
    t = t / np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    w = np.where((np.cross(n, t) * b).sum(-1) < 0.0, -1.0, 1.0)
    return np.concatenate([t, w[:, None]], axis=-1).astype(np.float32)


def use_all_slots(model, size: int = 64) -> None:
    """Give ``model``'s first mesh procedural textures in all five
    material slots -- base colour (a checker unless it has one), a
    tangent-space bump normal map, metallic-roughness (roughness along u,
    metallic along v), occlusion and emissive -- and tangents, so that
    the normal map takes effect.  Numpy only: it applies to the JAX
    package's Model too."""
    mesh = model.meshes[0]
    mat = mesh.material
    textures = model.textures
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    u = (xx + 0.5) / size
    v = (yy + 0.5) / size

    def add(img) -> int:
        textures.append(np.ascontiguousarray(img, dtype=np.uint8))
        return len(textures) - 1

    def rgba(r, g, b, a=255):
        return np.stack(np.broadcast_arrays(r, g, b, a), axis=-1)

    if mat.base_color_texture == DEFAULT_TEXTURE_MAP:
        ck = ((xx * 8 // size + yy * 8 // size) % 2).astype(bool)
        mat.base_color_texture = add(np.where(
            ck[..., None], np.array([60, 60, 60, 255], np.uint8),
            np.array([220, 220, 220, 255], np.uint8),
        ))
    # tangent-space normals of a bump field sin(2 pi 3u) sin(2 pi 3v)
    gx = 0.6 * np.cos(6 * np.pi * u) * np.sin(6 * np.pi * v)
    gy = 0.6 * np.sin(6 * np.pi * u) * np.cos(6 * np.pi * v)
    nrm = np.stack([-gx, -gy, np.ones_like(gx)], axis=-1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    mat.normal_texture = add(np.concatenate(
        [np.round((nrm * 0.5 + 0.5) * 255.0),
         np.full((size, size, 1), 255.0)], axis=-1,
    ))
    mr = _mr_gradient_texture(size)
    mr[..., 2] = np.round(v * 255.0)  # metallic along v
    mat.surface_properties_texture = add(mr)
    occ = np.round(255.0 * (1.0 - 0.6 * ((u - 0.5) ** 2 + (v - 0.5) ** 2)))
    mat.occlusion_texture = add(rgba(occ, occ, occ))
    stripes = ((xx // 4 + yy // 8) % 3 == 0) * 200.0
    mat.emissive_texture = add(rgba(stripes, stripes * 0.5, stripes * 0.2))
    mat.ormn = np.array([1.0, 1.0, 1.0, 1.0], np.float32)
    mat.emissive_factor_alpha_cutoff = np.array([0.6, 0.6, 0.6, 0.5],
                                                np.float32)
    mesh.primitive.tangent = _tangents(mesh.primitive)


def tiny_world(device=None, uv1=False, all_slots=False):
    world = World()
    cube = procedural_model("cube", textured=True, roughness=0.4)
    if uv1:
        use_uv1(cube)
    if all_slots:
        use_all_slots(cube)
    world.spawn((Transform.from_xyz(0.0, 0.5, 0.0), cube))
    world.spawn((
        Transform.from_xyz(1.2, 0.5, 0.0),
        procedural_model("sphere", base_color=(0.8, 0.2, 0.2, 1.0),
                         metallic=1.0, roughness=0.2),
    ))
    world.spawn((
        Transform.from_xyz(0.0, -0.5, 0.0),
        procedural_model("plane", size=8.0),
    ))
    world.spawn((DirectionalLight(
        Transform.from_xyz(5.0, 8.0, 5.0).looking_at((0.0, 0.0, 0.0)),
        (1.0, 1.0, 1.0), 4.0, True,
    ),))
    world.insert_resource(tiny_ibl(device))
    return world


def grid_world(n_grid: int = 10, device=None):
    """The reference's stress scene (``examples/sponza_scale.py``
    ``build_app``), spawned by the port's copy of that example
    (``examples.sponza_scale.spawn_scene``): a 40-unit textured plane, an
    ``n_grid`` x ``n_grid`` grid of alternating cubes and spheres with
    distinct materials, one shadow-casting sun over a 40 x 40 half-extent
    and four point lights.  The IBL is the tiny synthetic sky."""
    world = World()
    sponza_scale.spawn_scene(world, n_grid)
    world.insert_resource(tiny_ibl(device))
    return world


def budget_world(device=None):
    """A plane, a tall cube casting a long hard-edged shadow under a low
    sun, and a metallic sphere whose roughness ramps 0 -> 1 (the whole
    specular mip chain)."""
    world = World()
    world.spawn((
        Transform.from_xyz(0.0, -0.5, 0.0),
        procedural_model("plane", size=10.0, roughness=0.3),
    ))
    world.spawn((
        Transform.from_xyz(0.0, 0.5, 0.0),
        procedural_model("cube", base_color=(0.9, 0.6, 0.3, 1.0)),
    ))
    world.spawn((
        Transform.from_xyz(1.4, 0.1, 0.6),
        procedural_model("sphere", metallic=1.0, mr_gradient=True,
                         base_color=(0.9, 0.9, 0.9, 1.0)),
    ))
    world.spawn((DirectionalLight(
        Transform.from_xyz(8.0, 3.0, 2.0).looking_at((0.0, 0.0, 0.0)),
        (1.0, 1.0, 1.0), 4.0, True,
    ),))
    world.insert_resource(tiny_ibl(device))
    return world


# the fast path's knob sets and the deviation each may make from the
# full-rate frame on budget_world at 256x128 (tests/test_fast_budget.py
# BOUNDS): (pcf_res_divisor, spec_parent_mip_half_res,
# spec_mirror_half_res[, spec_merged_trilinear[, checkerboard[,
# ssao_res_divisor[, pcf_half_anchor]]]]) -> (mean LSB, fraction of
# channels > 12 LSB)
BUDGET_BOUNDS = {
    (2, False, False): (0.35, 0.004),
    (4, False, False): (0.60, 0.010),
    (1, True, False): (0.25, 0.004),
    (1, False, True): (0.35, 0.006),
    (4, True, True): (1.00, 0.015),
    (4, True, True, True): (1.10, 0.015),
    (4, True, True, True, True): (2.80, 0.060),
    (1, False, False, False, False, 2): (1.20, 0.020),
    (4, True, True, True, True, 2): (3.20, 0.070),
    (1, False, False, False, False, 1, True): (0.50, 0.008),
    (4, True, True, True, True, 2, True): (3.40, 0.075),
}
# the full-rate frame they are held to
BUDGET_ORACLE = (1, False, False)


def budget_config(cfg, knobs):
    """``cfg`` (the full-rate base: no checkerboard, full-rate SSAO) under
    one knob set of ``BUDGET_BOUNDS``."""
    divisor, parent, mirror, merged, cb, ssao_div, pcf_half = (
        tuple(knobs) + (False, False, 1, False)[len(knobs) - 3:])
    return dataclasses.replace(
        cfg, pcf_res_divisor=divisor, spec_parent_mip_half_res=parent,
        spec_mirror_half_res=mirror, spec_merged_trilinear=merged,
        checkerboard=cb, ssao_res_divisor=ssao_div, pcf_half_anchor=pcf_half)


def grid_camera(cfg):
    """The stress scene's camera (``examples.sponza_scale.scene_camera``),
    sized to ``cfg``."""
    cam = sponza_scale.scene_camera()
    cam.resize((cfg.width, cfg.height))
    return cam


def lit_camera(cfg):
    """grid_world(10) seen from 10 units over its 40-unit plane, 3 units
    back along the stress camera's yaw and pitched 1.2 rad towards the
    plane: the plane and the grid fill every pixel of the 1088-row frame,
    so no pixel is sky (an interior's share of lit pixels)."""
    yaw = np.pi * 0.8
    d = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
    cam = Camera(position=tuple(-3.0 * d + np.array([0.0, 10.0, 0.0])),
                 rotation=quat.mul(quat.from_rotation_y(yaw),
                                   quat.from_rotation_x(1.2)))
    cam.resize((cfg.width, cfg.height))
    return cam


# the tiny scene's view with no sky: 3 units over its 8-unit plane, 1.25
# back along the orbit camera's yaw, pitched 1.3 rad down; the frame's
# corner rays meet the plane within 2.9 units of its centre
TINY_LIT_VIEW = {"yaw": np.pi * 0.75, "back": 1.25, "height": 2.5,
                 "pitch": 1.3}


def tiny_lit_camera(cfg):
    """``tiny_world`` seen from TINY_LIT_VIEW: the plane, the cube and the
    sphere fill every pixel, so no pixel is sky."""
    v = TINY_LIT_VIEW
    d = np.array([np.sin(v["yaw"]), 0.0, np.cos(v["yaw"])])
    cam = Camera(position=tuple(-v["back"] * d
                                + np.array([0.0, v["height"], 0.0])),
                 rotation=quat.mul(quat.from_rotation_y(v["yaw"]),
                                   quat.from_rotation_x(v["pitch"])))
    cam.resize((cfg.width, cfg.height))
    return cam


def camera(cfg, angle: float = 0.0):
    """Orbit camera 3 units from the origin, 1 unit up (the reference's
    ``__graft_entry__._camera``)."""
    yaw = np.pi * 0.75 + angle
    d = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
    pos = tuple(-3.0 * d + np.array([0.0, 1.0, 0.0]))
    cam = Camera(position=pos, rotation=quat.from_rotation_y(yaw))
    cam.resize((cfg.width, cfg.height))
    return cam


def orbit_system(n_frames: int):
    """A runtime system that moves the world's camera along the
    reference benchmark's gentle orbit (``bench.py`` ``_path_params``):
    frame i sits at base + 0.05 * (sin a, 0, cos a - 1), a = 2 pi i / n."""
    state = {"i": 0, "base": None}

    def system(world):
        cam = world.resource(Camera)
        if state["base"] is None:
            state["base"] = np.asarray(
                cam.transform.translation, np.float64
            ).copy()
        a = 2.0 * math.pi * state["i"] / max(n_frames, 1)
        cam.transform.translation = (
            state["base"] + 0.05 * np.array([math.sin(a), 0.0, math.cos(a) - 1.0])
        ).astype(np.float32)
        cam.refresh_view()
        state["i"] += 1

    return system
