"""The asset-free scene the reference benchmarks and its goldens use
(``__graft_entry__._tiny_world`` / ``_tiny_config`` / ``_camera``),
rebuilt with the port's own classes: a textured cube, a metallic sphere,
a ground plane, one shadow-casting directional light and a synthetic
gradient sky, with the same entities and parameters.  Its UV1 variant
samples the cube's base colour with UV set 1, which sends the frame down
the reference sampling path.
"""

from __future__ import annotations

import math

import numpy as np

from .assets.ibl_resource import IBLResource
from .assets.procedural import procedural_model
from .config import EngineConfig
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


def synthetic_sky(h: int = 16, w: int = 32) -> np.ndarray:
    """Blue-to-warm gradient equirect panorama, (h, w, 3) float32."""
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    top = np.array([0.3, 0.5, 1.2], np.float32)
    bottom = np.array([1.0, 0.8, 0.6], np.float32)
    sky = top * (1.0 - y) + bottom * y
    return np.broadcast_to(sky, (h, w, 3)).copy()


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


def tiny_world(device=None, uv1=False):
    world = World()
    cube = procedural_model("cube", textured=True, roughness=0.4)
    if uv1:
        use_uv1(cube)
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
