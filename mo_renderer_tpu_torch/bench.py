"""Headline benchmark of the port (``bench.py``'s contract): the pbr_ibl
deferred PBR + IBL frame rate at 1920x1080 on one card.

    python -m mo_renderer_tpu_torch.bench

Prints ONE JSON line with ``bench.py``'s keys (``metric``, ``value``,
``unit``, ``vs_baseline`` = fps / 60, ``mpixels_per_s``, ``frames``,
``frames_per_dispatch``, ``resolution``, ``backend``) and two of its own:
``card`` (nvidia-smi's name and power limit of the card) and ``scene``.

The scene is the ``pbr_ibl`` example where ``resources/gltf`` exists,
else the asset-free ``scenes.tiny_world`` seen from ``scenes.camera``
(``scene`` says which).  3 warm-up frames, then ``MO_BENCH_FRAMES``
(default 30) timed frames of the runtime systems + ``render_device``,
frames left on the device, one synchronise before the timer starts and
one before it stops.  ``MO_BENCH_SEQ=K`` times ``render_sequence_device``
over a K-pose orbit instead (the frame captured once in a CUDA graph and
replayed per pose), ``MO_BENCH_FRAMES // K`` calls after a warm-up call.
Then the last frame must not be black and no frame may have dropped
geometry (``check_overflow``).
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np

from . import App, scenes
from .config import EngineConfig
from .device import card, resolve_device
from .examples import sync
from .passes.frame_graph import build_camera_params
from .passes.present import unpack_rgba8
from .scene.camera import Camera
from .scene.scene_buffers import find_shadow_light

WIDTH, HEIGHT = 1920, 1080
WARMUP_FRAMES = 3
BENCH_FRAMES = 30


def build_app(config: EngineConfig, device="cuda") -> tuple[App, str]:
    """(the App, the scene's name)."""
    if os.path.isdir(os.path.join(config.resource_root, "gltf")):
        from .examples.pbr_ibl import build_app as build

        return build(config, device), "pbr_ibl"

    # asset-free fallback: procedural scene + synthetic sky
    app = App.new(config=config, device=device)
    app.world = scenes.tiny_world()
    app.insert_resource(scenes.camera(config))
    return app, "tiny_world"


def _path_params(app, n):
    """n distinct per-frame camera params along a gentle orbit — a real
    animated camera path (every frame renders different pixels)."""
    camera = app.world.resource(Camera)
    light_pv, _ = find_shadow_light(app.world)
    base = np.asarray(camera.transform.translation, np.float64).copy()
    out = []
    for i in range(n):
        a = 2.0 * math.pi * i / max(n, 1)
        camera.transform.translation = (
            base + 0.05 * np.array([math.sin(a), 0.0, math.cos(a) - 1.0])
        ).astype(np.float32)
        camera.refresh_view()
        out.append(build_camera_params(camera, light_pv, app.device))
    camera.transform.translation = base.astype(np.float32)
    camera.refresh_view()
    return out


def run(config: EngineConfig, device="cuda", frames: int = BENCH_FRAMES,
        seq: int = 1) -> dict:
    """The benchmark at ``config``'s size on ``device``: its JSON record."""
    device = resolve_device(device)
    app, scene = build_app(config, device)
    app.resumed()
    renderer = app.renderer

    def device_frame():
        # the runtime systems + one frame, left on the device
        app.runtime_schedule.run(app.world)
        return renderer.render_device(app.world)

    if seq > 1:
        path = _path_params(app, seq)
        sync(renderer.render_sequence_device(app.world, path))  # warm
        n_dispatch = max(1, frames // seq)
        t0 = time.perf_counter()
        for _ in range(n_dispatch):
            out = renderer.render_sequence_device(app.world, path)
        sync(out)
        elapsed = time.perf_counter() - t0
        n_frames = n_dispatch * seq
        frame = out[-1]
    else:
        for _ in range(WARMUP_FRAMES):
            frame = device_frame()
        sync(frame)
        t0 = time.perf_counter()
        for _ in range(frames):
            frame = device_frame()
        sync(frame)
        elapsed = time.perf_counter() - t0
        n_frames = frames

    fps = n_frames / elapsed
    w, h = config.width, config.height
    rgba = unpack_rgba8(frame)
    if rgba.shape != (h, w, 4):
        raise RuntimeError(f"frame of shape {rgba.shape}, not {(h, w, 4)}")
    if not rgba[..., :3].max() > 0:
        raise RuntimeError("black frame")
    renderer.check_overflow()  # no frame may have dropped geometry
    return {
        "metric": f"pbr_ibl_{h}p_fps",
        "value": round(fps, 2),
        "unit": "fps",
        "vs_baseline": round(fps / 60.0, 3),
        "mpixels_per_s": round(fps * w * h / 1e6, 1),
        "frames": n_frames,
        "frames_per_dispatch": seq,
        "resolution": f"{w}x{h}",
        "backend": device.type,
        "card": card(device),
        "scene": scene,
    }


def main():
    frames = int(os.environ.get("MO_BENCH_FRAMES", str(BENCH_FRAMES)))
    seq = int(os.environ.get("MO_BENCH_SEQ", "1"))
    print(json.dumps(run(EngineConfig(width=WIDTH, height=HEIGHT),
                         frames=frames, seq=seq)))


if __name__ == "__main__":
    main()
