"""The traced run's record: torch.profiler over a stretch of the
traffic, reduced to plain lists that the metric readers take
(``metrics/*.py``), so they can be tested on synthetic records.

- ``device_ops``: every operation that ran on the device (kernels,
  copies, fills) as (name, start_us, end_us);
- ``host_ranges``: the benchmark's own ``bench::`` ranges as (name,
  start_us, end_us), the window's among them, and a ``bench::probe``
  range around each frame (or call of views) whose work the roofline
  shares count;
- ``units``: the frames (or views) the window ran; ``probed_units``: the
  frames (or views) inside the probe ranges.

``profile_passes`` is chip_smoke.py's method, copied: each function
``frame_program`` calls, wrapped in a ``record_function`` range by pass,
over eager frames, and the device time of each pass's kernels."""

from __future__ import annotations

import bisect
import collections
import contextlib
import re
import time

WINDOW = "bench::window"
PROBE = "bench::probe"
# ranges that mark out units of work, not a call the host is in
MARKS = (WINDOW, PROBE)
ANNOTATIONS = ("bench::", "pass::")


def record(prof, units: int) -> dict:
    """The neutral record of a finished ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, ranges = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == cuda:
            # a record_function range also shows on the device's row, as
            # an annotation over the work it queued: not an operation
            if not e.name.startswith(ANNOTATIONS):
                ops.append((e.name, float(tr.start), float(tr.end)))
        elif e.name.startswith("bench::"):
            ranges.append((e.name, float(tr.start), float(tr.end)))
    return {"device_ops": ops, "host_ranges": ranges, "units": units}


def _activities():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profiled(out: dict, units_of):
    """Profile the block (CPU and CUDA activities) inside one
    ``bench::window`` range; ``out`` gets the record and ``wall_s``.
    ``units_of()`` gives the frames or views the block ran."""
    import torch

    with torch.profiler.profile(activities=_activities()) as prof:
        _sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            yield
            _sync()
        out["wall_s"] = time.perf_counter() - t0
    out.update(record(prof, units_of()))


def span(name, fn):
    """``fn`` inside a ``bench::<name>`` range."""
    import torch

    def call(*args, **kwargs):
        with torch.profiler.record_function(f"bench::{name}"):
            return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def patched(pairs):
    """Set ``setattr(obj, name, value)`` for each (obj, name, value) over
    the block, and put the old values (or their absence) back after."""
    missing = object()
    saved = [(obj, name, obj.__dict__.get(name, missing)
              if hasattr(obj, "__dict__") else getattr(obj, name))
             for obj, name, _ in pairs]
    for obj, name, value in pairs:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, old in saved:
            if old is missing:
                delattr(obj, name)
            else:
                setattr(obj, name, old)


def window(rec: dict):
    """(start_us, end_us) of the traced window."""
    for name, a, b in rec["host_ranges"]:
        if name == WINDOW:
            return a, b
    raise ValueError("trace: no bench::window range")


def busy_us(rec: dict) -> float:
    """Device time covered by at least one operation inside the window."""
    a, b = window(rec)
    spans = sorted((max(s, a), min(e, b)) for _, s, e in rec["device_ops"]
                   if e > a and s < b)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(rec: dict):
    """[(start_us, end_us)] of the window's stretches with no device
    operation running."""
    a, b = window(rec)
    spans = sorted((max(s, a), min(e, b)) for _, s, e in rec["device_ops"]
                   if e > a and s < b)
    gaps, t = [], a
    for s, e in spans:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if b > t:
        gaps.append((t, b))
    return gaps


def label(name: str) -> str:
    """A device operation's name without its parameter list (a hand
    kernel keeps its template arguments)."""
    m = re.search(r"(\w+_kernel)(<.*?>)?(?=\()", name)
    if m:
        return m.group(1) + (m.group(2) or "")
    return name[:120]


def host_split(rec: dict, s: float, e: float, ranges=None) -> dict:
    """{range name: us} of the stretch (s, e): each instant goes to the
    innermost ``bench::`` range the host was in (the window's and the
    probes' ranges left out), "outside any range" where it was in none."""
    if ranges is None:
        ranges = [r for r in rec["host_ranges"] if r[0] not in MARKS]
    inside = [r for r in ranges if r[1] < e and r[2] > s]
    cuts = sorted({s, e} | {t for r in inside for t in r[1:]
                            if s < t < e})
    out = collections.Counter()
    for a, b in zip(cuts, cuts[1:]):
        mid = 0.5 * (a + b)
        cover = [r for r in inside if r[1] <= mid < r[2]]
        name = (min(cover, key=lambda r: r[2] - r[1])[0][len("bench::"):]
                if cover else "outside any range")
        out[name] += b - a
    return out


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle
    stretches' time by what the host was doing through them (the
    innermost ``bench::`` range): {"device_ops": [[name, s]],
    "idle_gaps": [[name, s]]}."""
    by_op = collections.Counter()
    for name, s, e in rec["device_ops"]:
        by_op[label(name)] += (e - s) / 1e6
    ranges = sorted((r for r in rec["host_ranges"] if r[0] not in MARKS),
                    key=lambda r: r[1])
    starts = [r[1] for r in ranges]
    longest = max((r[2] - r[1] for r in ranges), default=0.0)
    by_host = collections.Counter()
    for s, e in idle_gaps(rec):
        lo = bisect.bisect_left(starts, s - longest)
        hi = bisect.bisect_right(starts, e)
        for k, us in host_split(rec, s, e, ranges[lo:hi]).items():
            by_host[k] += us / 1e6
    return {"device_ops": [[k, v] for k, v in by_op.most_common(top)],
            "idle_gaps": [[k, v] for k, v in by_host.most_common(top)]}


# the functions frame_program calls, by the pass they belong to
# (chip_smoke.py's PASS_FUNCTIONS, frozen)
PASS_FUNCTIONS = {
    "vertex stage": ("run_vertex_stage", "pack_raster_attr_rows"),
    "shadow": ("shadow_map_from_clip", "shadow_program"),
    "triangle setup": ("triangle_setup_from_attrs", "triangle_setup"),
    "binning": ("_bin",),
    "raster": ("rasterize", "rasterize_attrs"),
    "decimate": ("decimate_cols",),
    "G-buffer": ("gbuffer_pass_fast", "gbuffer_pass",
                 "gbuffer_pass_from_planes"),
    "SSAO": ("ssao_pass_tiles", "ssao_pass", "_pad_edge", "_even_grid",
             "_upsample_to_cb", "_upsample_pow2"),
    "shading": ("shading_pass_fast", "shading_pass"),
    "present": ("reconstruct_present", "present_pass"),
}
# the hand kernels' names and the pass each one's device time goes to:
# a kernel launched from C is attached to no host op by the profiler
PASS_HAND_KERNELS = {
    "raster": ("raster_kernel", "raster_attrs_kernel"),
    "G-buffer": ("attr_planes_kernel", "stack_planes_kernel",
                 "gbuffer_kernel", "gbuffer_ref_kernel"),
    "SSAO": ("ssao_kernel",),
    "shading": ("shade_kernel", "shade_ref_kernel"),
    "present": ("reconstruct_kernel",),
}


def profile_passes(frame_module, run, n_frames: int):
    """({pass: device ms per frame}, {pass: [kernel label]}) over
    ``run(n_frames)`` (eager frames) with each of ``PASS_FUNCTIONS`` in
    ``frame_module`` wrapped in a ``pass::`` range; each pass counted
    without the passes it calls, with the kernels it ran."""
    import torch

    def ranged(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(f"pass::{name}"):
                return fn(*args, **kwargs)
        return call

    pairs = [(frame_module, fn, ranged(name, getattr(frame_module, fn)))
             for name, fns in PASS_FUNCTIONS.items() for fn in fns]
    with patched(pairs), \
            torch.profiler.profile(activities=_activities()) as prof:
        run(n_frames)
        _sync()

    def tally(evt, top, names):
        if not top and evt.name.startswith("pass::"):
            return 0.0
        names.update(label(k.name) for k in evt.kernels)
        us = sum(k.duration for k in evt.kernels)
        return us + sum(tally(c, False, names) for c in evt.cpu_children)

    events = prof.events()
    by_pass = {name: 0.0 for name in PASS_FUNCTIONS}
    kernels_of = {name: set() for name in PASS_FUNCTIONS}
    for evt in events:
        if evt.name.startswith("pass::"):
            name = evt.name[len("pass::"):]
            by_pass[name] += tally(evt, True, kernels_of[name])
    attached = {k.name for e in events for k in e.kernels}
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name not in attached):
            for name, kernels in PASS_HAND_KERNELS.items():
                if label(e.name).split("<")[0] in kernels:
                    by_pass[name] += e.time_range.elapsed_us()
                    kernels_of[name].add(label(e.name))
    return ({k: us / 1e3 / n_frames for k, us in by_pass.items()},
            {k: sorted(v) for k, v in kernels_of.items()})
