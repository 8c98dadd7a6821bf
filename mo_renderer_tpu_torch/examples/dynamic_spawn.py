"""dynamic_spawn — entities spawned/despawned mid-run (incremental repack),
port of ``examples/dynamic_spawn.py``.

Spawning an entity after startup rewrites rows of the packed scene in
place (``scene_buffers.incremental_repack``) instead of a full
``prepare``; despawning masks its triangles and must give the pre-spawn
frame back bit for bit.

    python -m mo_renderer_tpu_torch.examples.dynamic_spawn

Env overrides: MO_WIDTH/MO_HEIGHT, MO_OUT (PNG of the populated frame).
Exits non-zero unless the despawn restores the pre-spawn frame.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from ..assets.image_io import write_png
from ..assets.procedural import procedural_model
from ..config import EngineConfig
from ..math.transform import Transform
from ..passes.present import unpack_rgba8
from . import sky, sync
from .sponza_scale import build_app


def main(device="cuda", n_grid: int = 6, ibl=None) -> dict:
    """``ibl=None`` lights the scene with ``examples.sky``."""
    w = int(os.environ.get("MO_WIDTH", "1280"))
    h = int(os.environ.get("MO_HEIGHT", "720"))
    out = os.environ.get(
        "MO_OUT", os.path.join(tempfile.gettempdir(), "dynamic_spawn.png"))

    cfg = EngineConfig(width=w, height=h)
    sky_name = "given"
    if ibl is None:
        ibl, sky_name = sky(cfg)
    app = build_app(cfg, n_grid=n_grid, device=device, ibl=ibl)
    app.resumed()
    r = app.renderer
    # keep the full pre-spawn frame: the despawn check at the end compares
    # against these exact bytes
    f0 = r.render_device(app.world).clone()

    # spawn a tower of cubes one frame at a time (each repacks in place)
    spawned = []
    sync(f0)
    t0 = time.perf_counter()
    for i in range(6):
        spawned.append(app.world.spawn((
            Transform.from_xyz(0.0, 1.0 + 1.2 * i, 0.0),
            procedural_model(
                "cube", base_color=(1.0, 0.8 - 0.1 * i, 0.2, 1.0)
            ),
        )))
        app.runtime_schedule.run(app.world)
        frame = r.render_device(app.world)
    sync(frame)
    spawn_s = time.perf_counter() - t0
    write_png(out, unpack_rgba8(frame))

    # despawn them all: the frame must return to the pre-spawn frame
    # bit for bit
    for e in spawned:
        app.world.despawn(e)
    app.runtime_schedule.run(app.world)
    restored = r.render_device(app.world)
    r.check_overflow()
    bit_exact = bool(torch.equal(f0, restored))
    print(
        f"spawned 6 entities mid-run in {spawn_s:.2f}s total "
        f"(incremental, {r._prepare_count} full prepare(s)); wrote {out}; "
        f"despawn restored the pre-spawn frame bit-exactly: {bit_exact}; "
        f"sky {sky_name}, on {r.device}"
    )
    if not bit_exact:
        raise SystemExit("despawn did NOT restore the pre-spawn frame")
    return {"spawn_seconds": spawn_s, "bit_exact": bit_exact,
            "prepares": r._prepare_count, "sky": sky_name, "out": out}


if __name__ == "__main__":
    main()
