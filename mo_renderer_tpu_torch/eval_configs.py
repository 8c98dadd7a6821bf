"""The evaluation configs of ``scripts/eval_configs.py`` (BASELINE.json's
five and a stress scene), run by the port on one card:

  1. pbr_ibl_720p_ibl_only   — the pbr_ibl example, IBL only, 1280x720
  2. pbr_ibl_720p_full       — + PCF shadow + SSAO, 1280x720
  3. ibl_preprocess          — cold IBL precompute and its three checks
  4. sponza_1080p            — ~100 entities, 4 point + 1 dir, 1920x1080
  5. multi_view_4k           — 8 cameras at 3840x2160 over a 120-frame
                               path, frames left on the device
  6. stress_200k_1080p       — the 400-entity, ~200K-triangle grid, only
                               with MO_EVAL_STRESS=1

    python -m mo_renderer_tpu_torch.eval_configs

Prints ONE JSON object with a record per config, and writes it to
$MO_EVAL_OUT (default ``eval_configs_torch.json`` in the temporary
directory).  MO_EVAL_FRAMES (default 20) sets the timed frames,
MO_EVAL_ONLY (comma-separated names) picks configs, MO_EVAL_MV_FRAMES
(120) and MO_EVAL_MV_SEQ (4) size the multi-view path.

The sky is ``resources/tex/env/default_sky.hdr`` where it exists, else a
synthetic sky at the config's IBL sizes (``examples.sky``); each record
says which (``"sky"``).  The ``pbr_ibl_*`` configs need
``resources/gltf/man.glb`` (or $MO_MODEL) and report ``{"skipped": ...}``
without it.  A config that raises, or whose checks fail, is recorded with
its error and makes the script exit 1 after printing the JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

from .config import EngineConfig
from .device import card, resolve_device
from .examples import (
    multi_view_flythrough,
    pbr_ibl,
    sky,
    sponza_scale,
    sync,
)

FRAMES = 20


def _time_device_frames(render_device, n=FRAMES):
    """fps of a frame function whose frames stay on the device (one
    synchronise before the timer starts and one before it stops)."""
    sync(render_device())
    t0 = time.perf_counter()
    for _ in range(n):
        frame = render_device()
    sync(frame)
    return n / (time.perf_counter() - t0)


def _frame_rate(app, frames):
    """fps of the runtime systems + ``render_device`` on the resumed
    ``app``; no frame may have dropped geometry."""
    r = app.renderer

    def step():
        app.runtime_schedule.run(app.world)
        return r.render_device(app.world)

    fps = _time_device_frames(step, frames)
    r.check_overflow()
    return fps


def config_pbr_ibl(full_stack: bool, config=None, device="cuda",
                   frames=FRAMES) -> dict:
    cfg = dataclasses.replace(
        config or EngineConfig(width=1280, height=720),
        ssao_enabled=full_stack, shadow_enabled=full_stack,
    )
    model = os.environ.get("MO_MODEL", "man.glb")
    if not os.path.isfile(os.path.join(cfg.resource_root, "gltf", model)):
        return {"skipped": f"resources/gltf/{model} absent"}
    app = pbr_ibl.build_app(cfg, device)
    ibl, sky_name = sky(cfg)
    app.insert_resource(ibl)
    app.resumed()
    fps = _frame_rate(app, frames)
    w, h = cfg.width, cfg.height
    return {
        "fps": round(fps, 2),
        "mpixels_per_s": round(fps * w * h / 1e6, 1),
        "resolution": f"{w}x{h}",
        "stack": "shadow+ssao+ibl" if full_stack else "ibl_only",
        "sky": sky_name,
        "model": model,
    }


def config_ibl_preprocess(config=None, device="cuda", frames=FRAMES) -> dict:
    """The IBL chain's cold precompute (no disk cache) and its
    consistency checks against its input (BASELINE configs[3]: no
    Vulkan-side outputs exist, so the checks are against the environment:
    mirror-mip equality, irradiance bounded by the environment's range,
    every map finite, as in tests/test_kernels)."""
    cfg = config or EngineConfig()
    ibl, sky_name = sky(cfg, resolve_device(device), cache=False)
    t0 = time.perf_counter()
    ibl.ensure_computed()
    m = ibl.maps()
    sync(m.specular_mips.level(0))
    dt = time.perf_counter() - t0

    env = m.environment_faces.cpu().numpy()
    irr = m.irradiance_faces.cpu().numpy()
    mip0 = m.specular_mips.level(0).cpu().numpy()
    checks = {
        # specular mip 0 is the mirror level == environment map
        "mirror_mip_matches_env": bool(
            np.allclose(mip0[..., :3], env[..., :3], rtol=1e-3, atol=1e-3)
        ),
        # irradiance is a weighted average: bounded by the env's range
        "irradiance_bounded": bool(
            irr[..., :3].max() <= env[..., :3].max() * 1.05 + 1e-3
        ),
        "finite": bool(np.isfinite(env).all() and np.isfinite(irr).all()),
    }
    return {
        "precompute_seconds": round(dt, 3),
        "cubemap_size": int(env.shape[1]),
        "mips": int(m.specular_mips.num_levels),
        "checks": checks,
        "ok": all(checks.values()),
        "sky": sky_name,
    }


def _grid_config(cfg, device, frames, n_grid) -> dict:
    """fps and counts of the sponza_scale scene at ``n_grid``."""
    ibl, sky_name = sky(cfg)
    app = sponza_scale.build_app(cfg, n_grid=n_grid, device=device,
                                 ibl=ibl)
    app.resumed()
    fps = _frame_rate(app, frames)
    w, h = cfg.width, cfg.height
    return {
        "fps": round(fps, 2),
        "mpixels_per_s": round(fps * w * h / 1e6, 1),
        "resolution": f"{w}x{h}",
        "entities": n_grid * n_grid + 1,
        "tris": int(app.renderer.scene.tri_valid.sum()),
        "binned_cap": int(app.renderer._binned_cap),
        "sky": sky_name,
    }


def config_sponza(config=None, device="cuda", frames=FRAMES,
                  n_grid: int = 10) -> dict:
    return _grid_config(config or EngineConfig(width=1920, height=1080),
                        device, frames, n_grid)


def config_stress_200k(config=None, device="cuda", frames=FRAMES,
                       n_grid: int = 20) -> dict:
    """4x-sponza stress scene (~200K triangles, 401 entities): the
    past-BASELINE scaling probe of the binning.  Not a BASELINE config;
    main runs it only with MO_EVAL_STRESS=1."""
    cfg = config or EngineConfig(width=1920, height=1080, max_meshes=512,
                                 max_materials=512)
    return _grid_config(cfg, device, frames, n_grid)


def config_multi_view(config=None, device="cuda", frames=FRAMES,
                      n_grid: int = 8) -> dict:
    """The 120-frame offline camera path of BASELINE configs[4]: 8 views
    at 3840x2160, the path built on the host, MO_EVAL_MV_SEQ steps a
    call (``multi_view_flythrough.render_path``, over a world of one
    unless ``torch.distributed`` is initialised); MO_EVAL_MV_FRAMES trims
    the path."""
    cfg = config or EngineConfig(width=3840, height=2160)
    n_views = 8
    seq = int(os.environ.get("MO_EVAL_MV_SEQ", "4"))
    n_frames = max(int(os.environ.get("MO_EVAL_MV_FRAMES", "120")), seq)
    ibl, sky_name = sky(cfg)
    app = sponza_scale.build_app(cfg, n_grid=n_grid, device=device,
                                 ibl=ibl)
    app.resumed()
    _, stats = multi_view_flythrough.render_path(app, n_views, n_frames,
                                                 seq)
    vps = stats["views_per_s"]
    w, h = cfg.width, cfg.height
    return {
        "views_per_s": round(vps, 2),
        "mpixels_per_s": round(vps * w * h / 1e6, 1),
        "resolution": f"{w}x{h}",
        "views": n_views,
        "n_frames": stats["n_frames"],
        "devices": stats["devices"],
        "frames_per_dispatch": seq,
        "device_resident": True,
        "captures": stats["captures"],
        "sky": sky_name,
    }


def main(device="cuda") -> int:
    device = resolve_device(device)
    frames = int(os.environ.get("MO_EVAL_FRAMES", str(FRAMES)))
    run = dict(device=device, frames=frames)
    results = {"backend": device.type, "card": card(device),
               "frames": frames}
    runners = [
        ("pbr_ibl_720p_ibl_only", lambda: config_pbr_ibl(False, **run)),
        ("pbr_ibl_720p_full", lambda: config_pbr_ibl(True, **run)),
        ("ibl_preprocess", lambda: config_ibl_preprocess(**run)),
        ("sponza_1080p", lambda: config_sponza(**run)),
        ("multi_view_4k", lambda: config_multi_view(**run)),
    ]
    if os.environ.get("MO_EVAL_STRESS"):
        runners.append(("stress_200k_1080p",
                        lambda: config_stress_200k(**run)))
    only = os.environ.get("MO_EVAL_ONLY")  # comma-separated name filter
    if only:
        wanted = set(only.split(","))
        runners = [r for r in runners if r[0] in wanted]
    failed = []
    for name, fn in runners:
        print(f"[eval] {name} ...", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        try:
            res = fn()
        except Exception as e:  # record the failure, run the next config
            traceback.print_exc()
            res = {"error": f"{type(e).__name__}: {e}"}
        if "error" in res or res.get("ok") is False:
            failed.append(name)
        res["wall_seconds"] = round(time.perf_counter() - t0, 1)
        results[name] = res
        print(f"[eval] {name}: {res}", file=sys.stderr, flush=True)
    results["failed"] = failed

    out = json.dumps(results)
    print(out)
    path = os.environ.get(
        "MO_EVAL_OUT",
        os.path.join(tempfile.gettempdir(), "eval_configs_torch.json"))
    with open(path, "w") as f:
        f.write(out + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
