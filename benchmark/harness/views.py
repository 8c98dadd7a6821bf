"""The offline flythrough (traffic ``"loop": "views"``): a camera path of
``path_frames`` steps, each ``views`` cameras fanned by yaw from the
path's camera, rendered ``steps_per_call`` steps a call by
``MultiViewRenderer.render_view_sequence_device`` over the ranks of a
``torch.distributed`` group (one process and one card a rank), the
frames left on the device and one synchronise a call.  Rank 0 is the
process that prints the result; the others are started here and joined
before it does."""

from __future__ import annotations

import copy
import datetime
import gc
import math
import multiprocessing
import socket
import sys
import time

import numpy as np

from . import check, trace, traffic, world
from .sample import Reservoir


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rig(api, base, n_views: int) -> list:
    """``n_views`` cameras fanned around ``base`` by yaw offsets (the
    flythrough example's ``camera_rig``)."""
    out = []
    for k in range(n_views):
        cam = copy.deepcopy(base)
        dyaw = (k - (n_views - 1) / 2) * (2.0 * np.pi / max(n_views, 1)) / 4
        cam.transform.rotation = api.quat.mul(api.quat.from_rotation_y(dyaw),
                                              cam.transform.rotation)
        cam.refresh_view()
        out.append(cam)
    return out


def camera_path(api, run, cam) -> list:
    """[step][view] cameras of ``api`` along one loop of the traffic's
    camera ``cam``: each step's camera at its pose, its previous pose
    before it, fanned by ``rig``."""
    from .frames import _camera

    conf = run.cell.config
    cfg = api.EngineConfig(width=conf["width"], height=conf["height"])
    path = []
    for step in range(cam.period):
        base = _camera(api, cam.pose(step - 1), cfg)
        base.refresh_view()
        pos, rot = cam.pose(step)
        base.transform.translation = pos
        base.transform.rotation = rot
        base.refresh_view()
        path.append(rig(api, base, int(conf["views"])))
    return path


def run_rank(run, rank: int, n_ranks: int, port: int):
    """One rank's set-up, window, trace and check; every rank's record,
    gathered (on every rank)."""
    import torch
    import torch.distributed as dist

    if run.device.type == "cuda":
        torch.cuda.set_device(run.device)
    dist.init_process_group(
        "nccl" if run.device.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{port}", world_size=n_ranks,
        rank=rank, timeout=datetime.timedelta(seconds=300))
    try:
        rec = _rank(run, rank, n_ranks)
        everyone = [None] * n_ranks
        dist.all_gather_object(everyone, rec)
        return everyone
    finally:
        dist.destroy_process_group()


def _rank(run, rank, n_ranks) -> dict:
    import torch
    import torch.distributed as dist
    from mo_renderer_tpu_torch.assets.ibl_resource import IBLResource
    from mo_renderer_tpu_torch.parallel import (
        MultiViewRenderer,
        make_rank_group,
    )
    from mo_renderer_tpu_torch.passes.frame_graph import build_camera_params
    from mo_renderer_tpu_torch.scene.scene_buffers import find_shadow_light

    conf, tr = run.cell.config, run.cell.traffic
    api = world.port_api()
    cfg = api.EngineConfig(width=conf["width"], height=conf["height"],
                           **conf["engine"])
    n_views, seq = int(conf["views"]), int(conf["steps_per_call"])
    cam, edits = traffic.schedule(run, api)
    if edits:
        raise ValueError("traffic: the views loop takes no edits")
    group = make_rank_group()
    scene = world.build_world(api, run.recipe)
    scene.insert_resource(IBLResource.from_equirect(
        run.recipe["sky"], device=run.device, **conf["ibl"]))
    mv = MultiViewRenderer(cfg, group, run.device)
    mv.prepare(scene)
    light_pv, _ = find_shadow_light(scene)
    path = [[build_camera_params(c, light_pv, run.device) for c in cams]
            for cams in camera_path(api, run, cam)]
    n_path = len(path)
    v_local = -(-n_views // n_ranks)

    def steps(c):
        return [path[(c * seq + k) % n_path] for k in range(seq)]

    def call(c):
        frames = mv.render_view_sequence_device(steps(c), scene)
        run.sync()
        return frames

    warm = int(tr["warmup_calls"])
    for c in range(-warm - 2, -2):
        call(c)
    t0 = time.perf_counter()
    for c in (-2, -1):
        call(c)
    per_call = torch.tensor([(time.perf_counter() - t0) / 2])
    if run.device.type == "cuda":
        per_call = per_call.to(run.device)
    dist.broadcast(per_call, 0)  # every rank makes rank 0's count of calls
    # whole turns of the path, so that every seed renders the same views
    # (in another order): the seed sets only where the window starts
    turn = n_path // math.gcd(n_path, seq)
    n_calls = turn * max(1, round(run.seconds / float(per_call) / turn))

    sample = Reservoir(int(conf["check"]["frames"]), [run.seed, 5, rank])
    dist.barrier()
    setup_s = time.perf_counter() - run.t0
    t_start = time.perf_counter()
    for c in range(n_calls):
        frames = call(c)
        for k in range(seq):
            for v in range(v_local):
                g = rank * v_local + v
                if g < n_views:
                    sample.offer((c, k, g),
                                 lambda f=frames, k=k, v=v: f[k, v].clone())
    dist.barrier()
    window_s = time.perf_counter() - t_start
    failed = 0
    try:
        mv.check_overflow()
    except RuntimeError as exc:
        print(f"rank {rank}: {exc}", file=sys.stderr)
        failed = n_calls * seq * n_views
    rec = dict(setup_s=setup_s, window_s=window_s, calls=n_calls,
               views=n_calls * seq * n_views, attempted=n_calls * seq *
               n_views, failed=failed,
               memory_peak_bytes=run.memory_peak())
    probed = []
    if run.trace:
        # the first traced call is probed: the roofline shares count the
        # work of each of its views and divide by its kernels' time
        n_trace = int(tr["trace_calls"])
        out = {}
        render = trace.span("render_views", mv.render_view_sequence_device)
        sync = trace.span("synchronize", run.sync)
        probe = trace.span(trace.PROBE[len("bench::"):],
                           lambda c: (render(steps(c), scene), sync()))
        with trace.profiled(out, lambda: n_trace * seq * v_local):
            for c in range(n_calls, n_calls + n_trace):
                if c == n_calls:
                    probe(c)
                else:
                    render(steps(c), scene)
                    sync()
        probed = [(n_calls, k, g) for k in range(seq)
                  for g in range(rank * v_local,
                                 min((rank + 1) * v_local, n_views))]
        out["probed_units"] = seq * v_local
        rec["trace"] = out

    kept = [(key, f.cpu()) for key, f in sample.items]
    del mv, scene, path, sample
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()

    from ..reference.plain.passes.present import unpack_rgba8

    rapi = world.reference_api()
    ref_path = camera_path(rapi, run, cam)
    ref = run.reference_cache()((), lambda w: None)

    def cam_of(c, k, g):
        return ref_path[(c * seq + k) % n_path][g]

    tally = check.Tally()
    for (c, k, g), f in kept:
        tally.add(unpack_rgba8(f), ref.render(cam_of(c, k, g)),
                  f"call {c} step {k} view {g}")
    rec["tally"] = tally.state()
    if probed and run.cell.needs("work"):
        from .frames import work_of

        rec["work"] = work_of([lambda key=key: ref.render_packed(
            cam_of(*key)) for key in probed])
    from .main import forbidden_modules

    rec["forbidden"] = forbidden_modules()
    return rec


def _rank_process(root, argv, rank, n_ranks, port, device):
    from .main import make_run

    run = make_run(root, argv, rank=rank, device=device)
    run_rank(run, rank, n_ranks, port)


def run_views(run, argv, device=None) -> list:
    """Every rank's record, rank 0 in this process and the others in
    processes of their own, each joined before this returns (rank r on
    card r, or all on ``device``)."""
    n = run.cell.chips
    port = free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_process,
                         args=(run.root, argv, r, n, port, device))
             for r in range(1, n)]
    for p in procs:
        p.start()
    try:
        return run_rank(run, 0, n, port)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join()
