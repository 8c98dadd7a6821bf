"""The closed frame loop of an interactive app (traffic ``"loop":
"frames"``): ``App.render_frame`` one frame after another -- the
runtime systems (the Timer, the traffic's camera and edits,
``Camera.update_camera``), then ``Renderer.render``, which returns the
frame fetched to host memory.  The window's frames are timed on the
host's clock; a sample of them, drawn from the seed, is held to the
plain reference's render of the same pose and world after the window."""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from . import check, trace, traffic, world
from .sample import Reservoir

# every this many traced frames, one is probed: its reference frame's work
# is counted, and its kernels' time is what the roofline shares divide by
PROBE_EVERY = 10
# the label of a window frame that carried an edit, by the edit (the first
# frame of each label is checked)
EVENT = {"spawn": "repack"}


def _camera(api, pose, cfg):
    pos, rot = pose
    cam = api.Camera(position=tuple(float(x) for x in pos), rotation=rot)
    cam.resize((cfg.width, cfg.height))
    return cam


class FrameLoop:
    """The port's App on ``run.device`` fed by the traffic."""

    def __init__(self, run):
        import mo_renderer_tpu_torch as P
        from mo_renderer_tpu_torch.assets.ibl_resource import IBLResource

        self.run = run
        conf, tr = run.cell.config, run.cell.traffic
        self.api = api = world.port_api()
        self.recipe = run.recipe
        self.cfg = api.EngineConfig(width=conf["width"],
                                    height=conf["height"], **conf["engine"])
        self.camera_path, self.edits = traffic.schedule(run, api)
        self.i = -int(tr["warmup_frames"])
        self.spawned = {}  # spawn index -> Entity

        app = P.App.new(config=self.cfg, device=run.device)
        timer = api.Timer()
        timer.fixed_step = float(tr["timer_step_s"])
        app.insert_resource(timer)
        app.insert_resource(api.Input())
        app.init_resource(P.GlobalSamplers)
        app.insert_resource(IBLResource.from_equirect(
            self.recipe["sky"], device=run.device, **conf["ibl"]))
        world.populate(api, app.world, self.recipe)
        self.camera = _camera(api, self.camera_path.pose(self.i), self.cfg)
        app.insert_resource(self.camera)
        app.add_runtime_system(api.Timer.update_timer)
        app.add_runtime_system(self._move_camera)
        app.add_runtime_system(api.Camera.update_camera)
        app.add_runtime_system(self._edit)
        app.resumed()
        self.app = app

    # --- the traffic's runtime systems --------------------------------
    def _move_camera(self, _world) -> None:
        pos, rot = self.camera_path.pose(self.i)
        self.camera.transform.translation = pos
        self.camera.transform.rotation = rot

    def _edit(self, w) -> None:
        self.edits.apply(self.api, w, self.i, self.spawned)

    # --- set-up ---------------------------------------------------------
    def warm_up(self) -> None:
        """The warm-up frames before the window (the capture, the shadow
        graph, the edits of the frames before the window), and with
        spawns, spawn/despawn cycles until the padded rows run out and a
        full prepare has run, then one more cycle, so that the window
        meets nothing for the first time."""
        while self.i < 0:
            self.app.render_frame()
            self.i += 1
        spawns = self.edits.of(traffic.Spawns)
        if spawns is None:
            return
        self.i = -1  # the warm-up's cycles render the last warm-up pose
        r = self.app.renderer
        start = r._prepare_count
        ground = self.camera_path.ground_ahead(-1)

        def cycle(c):
            ent = world.spawn_entity(self.api, self.app.world,
                                     spawns.entity(c, ground))
            self.app.render_frame()
            self.app.world.despawn(ent)
            self.app.render_frame()

        for c in range(256):
            cycle(c)
            if r._prepare_count != start:
                break
        cycle(256)  # the in-place path again, on the new pack
        self.i = 0

    # --- the window -----------------------------------------------------
    def window(self, seconds: float, sample: Reservoir):
        """Frames until ``seconds`` have passed: the host seconds of each
        frame, of the frames that carry an edit, and the counts; a sample
        of the frames, and the first frame after an in-place repack, a
        despawn and a full prepare."""
        r = self.app.renderer
        frame_s, edit_s, events = [], [], {}
        failed = 0
        t_start = time.perf_counter()
        while True:
            i = self.i
            ops = self.edits.at(i)
            prepares = r._prepare_count
            t0 = time.perf_counter()
            try:
                frame = self.app.render_frame()
            except RuntimeError as exc:  # dropped geometry, a failed frame
                print(f"frame {i} failed: {exc}", file=sys.stderr)
                frame, failed = None, failed + 1
            t1 = time.perf_counter()
            frame_s.append(t1 - t0)
            if ops:
                edit_s.append(t1 - t0)
            if frame is not None:
                sample.offer(i, lambda f=frame: f)
                if ops:
                    kind = ("prepare" if r._prepare_count != prepares
                            else "+".join(sorted({EVENT.get(op, op)
                                                  for op, _ in ops})))
                    events.setdefault(kind, (i, frame))
            self.i += 1
            if t1 - t_start >= seconds:
                break
        return dict(window_s=t1 - t_start, frame_s=frame_s, edit_s=edit_s,
                    attempted=len(frame_s), failed=failed, events=events)

    def traced(self, n_frames: int) -> dict:
        """A profiled stretch of ``n_frames`` more frames of the traffic,
        with the host's calls into the port in ``bench::`` ranges and
        every ``PROBE_EVERY``-th frame in a ``bench::probe`` range (the
        frames whose work the roofline shares count), and the pass
        ranges of 2 eager frames of the last pose."""
        import mo_renderer_tpu_torch.passes.frame_graph as FG

        r = self.app.renderer
        sched = self.app.runtime_schedule
        out = {}
        pairs = [(r, "render_device", trace.span("render_device",
                                                 r.render_device)),
                 (r, "_sync_topology", trace.span("sync_topology",
                                                  r._sync_topology)),
                 (r, "check_overflow", trace.span("check_overflow",
                                                  r.check_overflow)),
                 (FG, "unpack_rgba8", trace.span("fetch", FG.unpack_rgba8)),
                 (sched, "run", trace.span("runtime_systems", sched.run))]
        probe = trace.span(trace.PROBE[len("bench::"):],
                           self.app.render_frame)
        n, probed = [0], []
        with trace.patched(pairs), trace.profiled(out, lambda: n[0]):
            for k in range(n_frames):
                if k % PROBE_EVERY == 0:
                    probe()
                    probed.append(self.i)
                else:
                    self.app.render_frame()
                self.i += 1
                n[0] += 1
        out["probed"], out["probed_units"] = probed, len(probed)

        def eager(k):
            for _ in range(k):
                r._sync_topology(self.app.world)
                params, has_light = r.frame_params(self.app.world)
                quads = r._cached_shadow_quads(
                    params.host_field("light_proj_view"),
                    params["light_proj_view"], has_light)
                rgba, overflow = r._frame(params, quads, has_light)
                r._note_overflow(overflow)

        out["passes"], out["pass_kernels"] = trace.profile_passes(FG, eager,
                                                                  2)
        r.check_overflow()
        return out


def reference_frames(camera_path, edits, keys, renderer_for, config):
    """(i, renderer, camera) of the plain reference for frames ``keys``:
    ``renderer_for(key, add)`` gives a renderer prepared on the world as
    edited at frame ``i`` (``add`` adds the edits to the recipe's world),
    the camera is at frame ``i``'s pose, its previous pose before it."""
    api = world.reference_api()
    out = []
    for i in keys:
        ref = renderer_for(edits.key(i),
                           lambda w, i=i: edits.build(api, w, i))
        cam = _camera(api, camera_path.pose(i - 1), config)
        cam.refresh_view()
        pos, rot = camera_path.pose(i)
        cam.transform.translation = pos
        cam.transform.rotation = rot
        cam.refresh_view()
        out.append((i, ref, cam))
    return out


def run_frames(run) -> dict:
    """Set-up, window, trace and check of a frames cell; the run's
    record."""
    import torch

    loop = FrameLoop(run)
    loop.warm_up()
    run.sync()
    setup_s = time.perf_counter() - run.t0
    sample = Reservoir(int(run.cell.config["check"]["frames"]),
                       [run.seed, 5])
    rec = loop.window(run.seconds, sample)
    rec["setup_s"] = setup_s
    q = np.quantile(np.array(rec["frame_s"]) * 1e3, [0.1, 0.5, 0.9, 0.99,
                                                      1.0])
    print(f"window: {len(rec['frame_s'])} frames in {rec['window_s']!r} s, "
          f"{len(rec['edit_s'])} with an edit; frame ms p10 p50 p90 p99 "
          f"max {' '.join(repr(float(x)) for x in q)}", file=sys.stderr,
          flush=True)
    rec["memory_peak_bytes"] = run.memory_peak()
    if run.trace:
        rec["trace"] = loop.traced(int(run.cell.traffic["trace_frames"]))
        for name, ms in rec["trace"]["passes"].items():
            print(f"pass {name} (eager frames): {ms!r} device ms a frame, "
                  f"kernels {rec['trace']['pass_kernels'][name]}",
                  file=sys.stderr, flush=True)
    frames = [(f"frame {i}", i, f) for i, f in sample.items]
    frames += [(f"first {k} frame {i}", i, f)
               for k, (i, f) in sorted(rec.pop("events").items())]
    camera_path, edits, cfg = loop.camera_path, loop.edits, loop.cfg

    # the program's state goes before the reference runs
    del loop, sample
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()

    refs = run.reference_cache()
    tally = check.Tally()
    for (label, i, frame), (_, ref, cam) in zip(
            frames, reference_frames(camera_path, edits,
                                     [f[1] for f in frames], refs, cfg)):
        tally.add(frame, ref.render(cam), label)
    rec["tally"] = tally.state()
    if run.trace and run.cell.needs("work"):
        rec["work"] = work_of(
            [lambda ref=ref, cam=cam: ref.render_packed(cam)
             for _, ref, cam in reference_frames(
                 camera_path, edits, rec["trace"]["probed"], refs, cfg)])
    return rec


def work_of(renders) -> dict:
    """{pass: bound ms per frame}, the mean over the reference frames
    ``renders`` (callables) of ``roofline.work.probe``."""
    from ..roofline import work

    probes = [work.probe(r) for r in renders]
    if not probes:
        return {}
    return {k: float(np.mean([p[k] for p in probes])) for k in probes[0]
            if all(k in p for p in probes)}
