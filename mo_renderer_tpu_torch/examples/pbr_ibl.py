"""pbr_ibl — the flagship example, port of ``examples/pbr_ibl.py``, which
mirrors the reference's examples/pbr_ibl/main.rs:12-55 call for call.

The reference scene loads ``DamagedHelmet.glb`` (not shipped in its asset
tree); the shipped helmet-class model is ``man.glb``.  Set $MO_MODEL to
point at any .glb.  Renders headless frames and writes a PNG; with
``--window``, the live WASD + right-mouse-drag loop.  It needs
``resources/gltf/<model>`` and ``resources/tex/env/default_sky.hdr``.

    python -m mo_renderer_tpu_torch.examples.pbr_ibl [--window]

Env overrides: MO_MODEL, MO_FRAMES, MO_OUT.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from .. import (
    App,
    Camera,
    DefaultTextures,
    DirectionalLight,
    GlobalSamplers,
    IBLResource,
    Input,
    Model,
    Timer,
    Transform,
)
from ..app.application import EventLoop
from ..math import quat


def build_app(config=None, device="cuda") -> App:
    event_loop = EventLoop()
    app = App.new(event_loop, config, device)

    app.init_resource(Timer)
    app.init_resource(Input)

    app.init_resource(DefaultTextures)
    app.init_resource(IBLResource)
    app.init_resource(GlobalSamplers)

    app.add_runtime_system(Timer.update_timer)
    app.add_runtime_system(Camera.update_camera)

    camera = Camera(
        position=(-3.0, 0.0, 3.0),
        rotation=quat.from_rotation_y(np.pi * 0.75),
    )
    app.insert_resource(camera)

    model_name = os.environ.get("MO_MODEL", "man.glb")
    app.add_entity((
        Transform.from_xyz(0.0, 0.0, 0.0),
        Model.load_gltf(model_name),
    ))

    app.add_entity((DirectionalLight(
        Transform.from_xyz(10.0, 10.0, 10.0).looking_at((0.0, 0.0, 0.0)),
        (1.0, 1.0, 1.0),
        4.0,
        True,
    ),))

    app.add_entity((DirectionalLight(
        Transform.from_xyz(-10.0, 10.0, 10.0).looking_at((0.0, 0.0, 0.0)),
        (1.0, 1.0, 1.0),
        2.0,
        False,
    ),))

    return app


def main():
    app = build_app()
    if "--window" in sys.argv:
        # live WASD + right-mouse-drag flight (README.md:15-24)
        from ..app.window import run_windowed

        shown = run_windowed(app)
        print(f"window closed after {shown} frames, "
              f"fps={app.world.resource(Timer).fps():.1f}")
        return
    frames = int(os.environ.get("MO_FRAMES", "1"))
    out = os.environ.get(
        "MO_OUT", os.path.join(tempfile.gettempdir(), "pbr_ibl.png"))
    frame = app.run(num_frames=frames)
    app.save_frame(out, frame)
    print(f"wrote {out} ({frame.shape[1]}x{frame.shape[0]}), "
          f"fps={app.world.resource(Timer).fps():.1f}")


if __name__ == "__main__":
    main()
