"""sponza_scale — Sponza-class stress scene (BASELINE.json configs[3]), port
of ``examples/sponza_scale.py``.

~100 ECS entities with distinct PBR materials (textured + untextured mix),
4 point lights + 1 shadow-casting directional light, 1920x1080 headless.
The reference ships no Sponza asset, so the scene is procedural but matches
the config's entity/light/material counts and resolution.  ``spawn_scene``
is the scene itself; ``scenes.grid_world`` builds its world with it.

    python -m mo_renderer_tpu_torch.examples.sponza_scale

Env overrides: MO_FRAMES, MO_OUT, MO_WIDTH/MO_HEIGHT.  The sky is
``resources/tex/env/default_sky.hdr`` where it exists, else the
synthetic sky (``examples.sky``); the output line names it.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np

from .. import (
    App,
    Camera,
    DefaultTextures,
    DirectionalLight,
    GlobalSamplers,
    IBLResource,
    Input,
    PointLight,
    Timer,
    Transform,
)
from ..assets.procedural import procedural_model
from ..config import EngineConfig
from ..math import quat
from ..passes.present import unpack_rgba8
from . import sky, sync


def scene_camera() -> Camera:
    """14 units back and 4 up, pitched down by 0.2 rad."""
    yaw = np.pi * 0.8
    d = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
    return Camera(
        position=tuple(-14.0 * d + np.array([0.0, 4.0, 0.0])),
        rotation=quat.mul(
            quat.from_rotation_y(yaw), quat.from_rotation_x(-0.2)
        ),
    )


def spawn_scene(world, n_grid: int = 10) -> None:
    """Spawn the scene's entities into ``world``, in the reference's order:
    a 40-unit textured plane, an ``n_grid`` x ``n_grid`` grid of
    alternating cubes and spheres (colours, heights and roughness from
    ``default_rng(42)`` in the reference's draw order), one shadow caster
    and four point lights."""
    world.spawn((
        Transform.from_xyz(0.0, 0.0, 0.0),
        procedural_model("plane", size=40.0, textured=True, roughness=0.8),
    ))

    rng = np.random.default_rng(42)
    for i in range(n_grid):
        for j in range(n_grid):
            x = (i - (n_grid - 1) / 2) * 2.4
            z = (j - (n_grid - 1) / 2) * 2.4
            kind = "cube" if (i + j) % 2 == 0 else "sphere"
            color = tuple(rng.uniform(0.2, 1.0, 3)) + (1.0,)
            model = procedural_model(
                kind,
                base_color=color,
                metallic=float((i * n_grid + j) % 3 == 0),
                roughness=float(0.1 + 0.8 * rng.random()),
                textured=(i + j) % 5 == 0,
            )
            world.spawn((
                Transform.from_xyz(x, 0.5 + 0.8 * rng.random(), z),
                model,
            ))

    # 1 shadow caster + 4 point lights (configs[3])
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


def build_app(config: EngineConfig | None = None, n_grid: int = 10,
              device="cuda", ibl: IBLResource | None = None) -> App:
    """The scene in an App on ``device``.  ``ibl=None`` is
    ``IBLResource()``, the configured sky file, as in the reference (its
    absence raises in ``resumed``); a caller without it passes another
    resource (``examples.sky``)."""
    app = App.new(config=config, device=device)
    app.init_resource(Timer)
    app.init_resource(Input)
    app.init_resource(DefaultTextures)
    app.init_resource(GlobalSamplers)
    if ibl is None:
        app.init_resource(IBLResource)
    else:
        app.insert_resource(ibl)

    app.add_runtime_system(Timer.update_timer)
    app.add_runtime_system(Camera.update_camera)
    app.insert_resource(scene_camera())
    spawn_scene(app.world, n_grid)
    return app


def main(device="cuda") -> dict:
    w = int(os.environ.get("MO_WIDTH", "1920"))
    h = int(os.environ.get("MO_HEIGHT", "1080"))
    cfg = EngineConfig(width=w, height=h)
    ibl, sky_name = sky(cfg)
    app = build_app(cfg, device=device, ibl=ibl)
    frames = int(os.environ.get("MO_FRAMES", "3"))
    out = os.environ.get(
        "MO_OUT", os.path.join(tempfile.gettempdir(), "sponza_scale.png"))
    app.resumed()
    r = app.renderer
    frame = r.render_device(app.world)
    sync(frame)
    t0 = time.perf_counter()
    for _ in range(frames):
        frame = r.render_device(app.world)
    sync(frame)
    dt = (time.perf_counter() - t0) / frames
    r.check_overflow()
    app.save_frame(out, unpack_rgba8(frame))
    tris = int(r.scene.tri_valid.sum())
    print(f"wrote {out} ({w}x{h}), {1.0 / dt:.2f} fps ({tris} tris), "
          f"sky {sky_name}, on {r.device}")
    return {"fps": 1.0 / dt, "tris": tris, "sky": sky_name, "out": out}


if __name__ == "__main__":
    main()
