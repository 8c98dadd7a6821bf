"""multi_view_flythrough — batched multi-view camera path
(BASELINE.json configs[4]), port of ``examples/multi_view_flythrough.py``.

8 cameras rendered at 4K over the ranks of a ``torch.distributed`` group
(``parallel.MultiViewRenderer``), driven through a 120-frame WASD-style
path: a scripted Input feeds the same ``Camera.update_camera`` system the
interactive loop uses (camera.rs:256-351), and the camera rig derives the
8 views by yaw offsets each frame.  The path is rendered ``MO_SEQ`` steps
a call (``render_view_sequence_device``: each view of each step a replay
of the frame's captured CUDA graph on a card).

    python -m mo_renderer_tpu_torch.examples.multi_view_flythrough

The group is that of the initialised ``torch.distributed`` world; without
one, ``main`` starts a world of one (NCCL on a card, gloo on the CPU).
Env overrides: MO_FRAMES (default 120), MO_VIEWS (8), MO_WIDTH/MO_HEIGHT
(3840x2160), MO_SEQ (4), MO_OUT.
"""

from __future__ import annotations

import contextlib
import copy
import os
import socket
import tempfile
import time

import numpy as np
import torch.distributed as dist

from .. import Camera, Input
from ..assets.image_io import write_png
from ..config import EngineConfig
from ..math import quat
from ..parallel import MultiViewRenderer, make_rank_group
from ..passes.frame_graph import build_camera_params
from ..passes.present import unpack_rgba8
from ..scene.input import EInputButton
from ..scene.scene_buffers import find_shadow_light
from . import sky, sync
from .sponza_scale import build_app


def scripted_input(input_res: Input, step: int) -> None:
    """WASD-style script: fly forward, drag-look around, strafe."""
    input_res.press(EInputButton.key("W"))
    if step % 40 == 20:
        input_res.press(EInputButton.MOUSE_RIGHT)
    input_res.move_mouse(6.0 * np.sin(step * 0.1), 2.0 * np.cos(step * 0.13))
    if 30 <= step % 60 < 45:
        input_res.press(EInputButton.key("D"))
    else:
        input_res.release(EInputButton.key("D"))


def camera_rig(base: Camera, n_views: int) -> list[Camera]:
    """n_views cameras fanned around the base camera by yaw offsets."""
    rig = []
    for k in range(n_views):
        cam = copy.deepcopy(base)
        dyaw = (k - (n_views - 1) / 2) * (2.0 * np.pi / max(n_views, 1)) / 4
        cam.transform.rotation = quat.mul(
            quat.from_rotation_y(dyaw), cam.transform.rotation
        )
        cam.refresh_view()
        rig.append(cam)
    return rig


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def rank_group(device):
    """``make_rank_group()`` of the initialised ``torch.distributed``
    world; without one, of a world of one started here (NCCL for a card's
    ``device``, gloo for the CPU, on 127.0.0.1 and a free port) and
    destroyed on exit."""
    if dist.is_initialized():
        yield make_rank_group()
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        yield make_rank_group()
    finally:
        dist.destroy_process_group()


def render_path(app, n_views: int, n_frames: int, seq: int):
    """The camera path of ``n_frames`` steps x ``n_views`` views of the
    resumed ``app`` over ``rank_group``, ``seq`` steps a call after a
    warm-up call (the capture): (the last call's frames, left on the
    device, and {"views_per_s", "n_frames", "devices", "captures"}).
    ``n_frames`` is rounded up to a multiple of ``seq``."""
    w, h = app.config.width, app.config.height
    with rank_group(app.device) as group:
        mv = MultiViewRenderer(app.config, group, app.device)
        mv.prepare(app.world)

        camera: Camera = app.world.resource(Camera)
        input_res: Input = app.world.resource(Input)
        camera.resize((w, h))

        # the whole camera path on the host (scripted input ->
        # Camera.update_camera -> per-view params)
        n_frames = ((n_frames + seq - 1) // seq) * seq
        light_pv, _ = find_shadow_light(app.world)
        steps = []
        for step in range(n_frames):
            scripted_input(input_res, step)
            app.runtime_schedule.run(app.world)  # Timer + update_camera
            steps.append([
                build_camera_params(c, light_pv, app.device)
                for c in camera_rig(camera, n_views)
            ])

        # warm-up (the capture) outside the timed loop; the frames stay
        # on the device
        frames_dev = mv.render_view_sequence_device(steps[:seq], app.world)
        sync(frames_dev)
        t0 = time.perf_counter()
        for k in range(0, n_frames, seq):
            frames_dev = mv.render_view_sequence_device(
                steps[k: k + seq], app.world
            )
        sync(frames_dev)
        elapsed = time.perf_counter() - t0
        mv.check_overflow()
        n_devices = group.size
    return frames_dev, {
        "views_per_s": n_frames * n_views / elapsed, "n_frames": n_frames,
        "devices": n_devices, "captures": mv._inner._captures,
    }


def main(device="cuda") -> dict:
    w = int(os.environ.get("MO_WIDTH", "3840"))
    h = int(os.environ.get("MO_HEIGHT", "2160"))
    n_views = int(os.environ.get("MO_VIEWS", "8"))
    n_frames = int(os.environ.get("MO_FRAMES", "120"))
    seq = max(1, int(os.environ.get("MO_SEQ", "4")))
    out = os.environ.get(
        "MO_OUT", os.path.join(tempfile.gettempdir(), "multi_view.png"))

    cfg = EngineConfig(width=w, height=h)
    ibl, sky_name = sky(cfg)
    app = build_app(cfg, n_grid=8, device=device, ibl=ibl)
    app.resumed()
    frames_dev, stats = render_path(app, n_views, n_frames, seq)

    vps = stats["views_per_s"]
    # only the last step's middle view is fetched
    write_png(out, unpack_rgba8(frames_dev[-1, n_views // 2]))
    print(
        f"{stats['n_frames']} frames x {n_views} views @ {w}x{h} over "
        f"{stats['devices']} device(s): {vps:.2f} views/s "
        f"({vps * w * h / 1e6:.1f} Mpix/s); {stats['captures']} "
        f"capture(s); sky {sky_name}; wrote {out}"
    )
    return dict(stats, views=n_views, frames_per_dispatch=seq,
                sky=sky_name, out=out)


if __name__ == "__main__":
    main()
