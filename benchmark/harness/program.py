"""Readers of the port's own tracer (``mo_renderer_tpu_torch/utils/trace.py``)
over a cell's traffic: its spans, counters and pass markers, reduced to
per-layer numbers.

No cell reads these yet: the run's record (``frames.py``, ``views.py``)
does not hold the tracer's snapshots, and ``trace.record`` counts the
program's ``mo::`` ranges on the device's row as operations.  A
benchmark change that wires them in moves this module into those files.

The readers take a run's record with these keys:

- ``trace``: a profiled stretch of the traffic with the tracer on, from
  ``record`` (the program's ``mo::`` ranges kept apart, and the
  operations of each graph launch);
- ``program``: the tracer's ``snapshot()`` points, each {"counters",
  "n_spans"} (the counters then, and the span log's length), at
  ``setup_start``, ``window_start``, ``window_end``, ``traced_start``
  and ``traced_end``, and ``spans``, the span log at the end;
- ``frame_s``: the window's frame times.

A record of a program without the tracer has no ``program`` key and no
markers: every reader returns None on it."""

from __future__ import annotations

import collections
import re
import statistics

from . import trace

PROGRAM = "mo::"
MARK = re.compile(r"mo_mark_kernel<(\d+)>")


# --- the profiled stretch's record -------------------------------------
def record(prof, units: int) -> dict:
    """``trace.record`` with the program's ranges: its ``mo::`` ranges on
    the device's row are annotations, not operations, and on the host
    they go to ``program_ranges``.  ``graph_ops`` holds, per
    ``cudaGraphLaunch`` the profiler linked to its operations, those
    operations (an empty list where it linked none)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    rec = trace.record(prof, units)
    rec["device_ops"] = [o for o in rec["device_ops"]
                         if not o[0].startswith(PROGRAM)]
    skip = trace.ANNOTATIONS + (PROGRAM,)
    program, by_id, launches = [], {}, set()
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == cuda:
            if not e.name.startswith(skip):
                by_id.setdefault(e.id, []).append(span)
        elif e.name.startswith(PROGRAM):
            program.append(span)
        elif e.name.startswith("cudaGraphLaunch"):
            launches.add(e.id)
    rec["program_ranges"] = program
    rec["graph_ops"] = [sorted(by_id[i], key=lambda s: s[1])
                        for i in sorted(launches) if i in by_id]
    return rec


def _ranges(rec):
    """The host's ranges of both kinds for ``trace.host_split``: a
    program range keeps its ``mo::`` in the name it reports."""
    return ([r for r in rec["host_ranges"] if r[0] not in trace.MARKS]
            + [("bench::" + n, s, e) for n, s, e in
               rec.get("program_ranges", ())])


def idle_split(rec: dict, ranges=None) -> dict:
    """{range: s} of the traced window's idle time, each instant under
    the innermost range, of either kind, the host was in."""
    ranges = _ranges(rec) if ranges is None else ranges
    out = collections.Counter()
    for s, e in trace.idle_gaps(rec):
        for k, us in trace.host_split(rec, s, e, ranges).items():
            out[k] += us / 1e6
    return dict(out)


def idle_under(rec: dict, name: str) -> dict | None:
    """The idle time inside the program's ``name`` ranges: {"total_s",
    "self_s" (the range itself innermost), "children_s" (a range inside
    it innermost)}; None without such a range."""
    key = PROGRAM + name
    inside = [("bench::" + n, s, e) for n, s, e in
              rec.get("program_ranges", ()) if n == key]
    if not inside:
        return None
    total = idle_split(rec, inside).get(key, 0.0)
    own = idle_split(rec).get(key, 0.0)
    return {"total_s": total, "self_s": own, "children_s": total - own}


def marked_passes(rec: dict) -> dict | None:
    """The device time of each replayed pass, read between the markers of
    the captured programs (``kernels/mark.py`` ``PASSES``; an operation goes to the
    pass whose marker came last): {"replays": replays of the frame
    program, "ms": {pass: device ms a replay}, "shadow_replays",
    "shadow_ms" (a replay of the memoized shadow's program), "marker_us"
    (the markers' device us a frame replay), "unmarked": operations of a
    graph launch outside its first and last marker, or None where the
    profiler linked no operation to a launch}.  None without markers."""
    ops = sorted(rec["device_ops"], key=lambda o: o[1])

    def mark(name):
        m = MARK.search(name)
        return int(m.group(1)) if m else None

    if not any(mark(o[0]) is not None for o in ops):
        return None
    from mo_renderer_tpu_torch.kernels.mark import END, PASSES

    by = {"frame": collections.Counter(), "shadow": collections.Counter()}
    ends = collections.Counter()
    marker_us, cur, program = 0.0, None, None
    for name, s, e in ops:
        k = mark(name)
        if k is None:
            if cur is not None:
                by[program][PASSES[cur]] += e - s
            continue
        marker_us += e - s
        if k == END:
            ends[program] += 1
            cur = program = None
        else:
            if program is None:
                program = "shadow" if PASSES[k] == "shadow" else "frame"
            cur = k
    n, n_shadow = ends["frame"], ends["shadow"]

    def outside(g):
        at = [i for i, o in enumerate(g) if mark(o[0]) is not None]
        return len(g) - (at[-1] - at[0] + 1) if at else len(g)

    graphs = rec.get("graph_ops")
    return {"replays": n,
            "ms": {p: us / 1e3 / n for p, us in by["frame"].items()}
            if n else {},
            "shadow_replays": n_shadow,
            "shadow_ms": (sum(by["shadow"].values()) / 1e3 / n_shadow
                          if n_shadow else None),
            "marker_us": marker_us / n if n else None,
            "unmarked": (sum(outside(g) for g in graphs) if graphs
                         else None)}


# --- the tracer's snapshots --------------------------------------------
def _between(run, a: str, b: str):
    """(spans, lo, hi): the program's span log and the index range of the
    spans opened between its points ``a`` and ``b``; None without them."""
    prog = run.get("program")
    if not prog or a not in prog or b not in prog:
        return None
    return prog["spans"], prog[a]["n_spans"], prog[b]["n_spans"]


def _ms(spans, lo, hi, name):
    return [(s[4] - s[3]) / 1e6 for s in spans[lo:hi] if s[0] == name]


def render_device_host_ms(run) -> float | None:
    """The mean host ms of the ``render_device`` span over the traced
    stretch's frames."""
    got = _between(run, "traced_start", "traced_end")
    ms = _ms(*got, "render_device") if got else []
    return statistics.fmean(ms) if ms else None


def repack_ms(run) -> float | None:
    """The median host ms of the window's ``repack`` spans."""
    got = _between(run, "window_start", "window_end")
    ms = _ms(*got, "repack") if got else []
    return statistics.median(ms) if ms else None


def full_prepares_per_kframe(run) -> float | None:
    """The ``prepares`` counter's growth over the window, per 1000 window
    frames."""
    prog = run.get("program")
    if not prog or not run.get("frame_s"):
        return None
    n = (prog["window_end"]["counters"].get("prepares", 0)
         - prog["window_start"]["counters"].get("prepares", 0))
    return 1e3 * n / len(run["frame_s"])


def prepare_frame_ms(run) -> float | None:
    """The median host ms (the ``frame`` span) of the window frames that
    held a full prepare."""
    got = _between(run, "window_start", "window_end")
    if not got:
        return None
    spans, lo, hi = got
    roots = set()
    for i in range(lo, hi):
        if spans[i][0] == "prepare":
            while spans[i][1] is not None:
                i = spans[i][1]
            roots.add(i)
    ms = [(spans[i][4] - spans[i][3]) / 1e6 for i in roots
          if spans[i][0] == "frame"]
    return statistics.median(ms) if ms else None


def ibl_precompute_s(run) -> float | None:
    """The ``ibl_precompute`` span of the set-up (before the window)."""
    got = _between(run, "setup_start", "window_start")
    ms = _ms(*got, "ibl_precompute") if got else []
    return sum(ms) / 1e3 if ms else None


def replay_setup_binning_ms(run) -> float | None:
    """Device ms a replayed frame (or view) between the triangle-setup
    and the binning markers."""
    rec = run.get("trace")
    got = marked_passes(rec) if rec else None
    if not got or not got["replays"]:
        return None
    ms = got["ms"]
    if "triangle setup" not in ms and "binning" not in ms:
        return None
    return ms.get("triangle setup", 0.0) + ms.get("binning", 0.0)


def window_split(run) -> dict | None:
    """Host ms of each span name (children counted in their parents too)
    a window frame (or views call), on the tracer's clock without the
    profiler: {"all": over the window's roots, "prepare": over the roots
    that held a full prepare}."""
    got = _between(run, "window_start", "window_end")
    if not got:
        return None
    spans, lo, hi = got
    roots = [i for i in range(lo, hi) if spans[i][1] is None] + [hi]
    out = {"all": collections.Counter(), "prepare": collections.Counter()}
    n = {"all": 0, "prepare": 0}
    for a, b in zip(roots, roots[1:]):
        kinds = ["all"] + (["prepare"] if any(
            s[0] == "prepare" for s in spans[a:b]) else [])
        for k in kinds:
            n[k] += 1
            for s in spans[a:b]:
                out[k][s[0]] += (s[4] - s[3]) / 1e6
    return {k: {name: ms / n[k] for name, ms in c.most_common()}
            for k, c in out.items() if n[k]}


READERS = {f.__name__: f for f in (
    render_device_host_ms, replay_setup_binning_ms, repack_ms,
    full_prepares_per_kframe, prepare_frame_ms, ibl_precompute_s)}
