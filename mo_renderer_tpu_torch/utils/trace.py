"""The port's tracer: named spans and counters inside the program.

Spans are off by default; ``enable()`` and ``disable()`` switch them.
Counters are always on.

- ``span(name)`` times a block.  Off, it returns one shared no-op context
  after a single check of a module global.  On, the span appends
  ``(name, parent, frame, start_ns, end_ns)`` to an in-memory log on the
  host clock (``time.perf_counter_ns``): ``parent`` is the log index of
  the enclosing span (None at the root), ``frame`` the frame id that
  ``set_frame`` gave (``App.frame_index``; a ``MultiViewRenderer`` call's
  index).  While a ``torch.profiler`` records, the span also opens a
  ``record_function("mo::<name>")`` range, so it lies on the profiler's
  clock beside the device's operations.
- ``kernels/mark.py``'s ``pass_span(name)`` is the span ``pass::<name>``
  of one pass of a captured program, with a marker kernel at each of its
  ends in a graph being captured.
- ``count(name, n)`` adds to a plain dict of integers.  Its counters:
  ``prepares``, the full prepares of every renderer of the process;
  ``fetch_bytes``, the bytes of the frames ``passes/present.py``
  ``unpack_rgba8`` fetched from a tensor; ``fetch_pinned``, those fetches
  that came from a card through page-locked memory; ``reference_frames``,
  the frames rendered on the reference sampling path (``fast_sampling``
  off, or a material that samples UV set 1), each frame of a sequence or
  a views call one; ``camera_block_builds``, the camera blocks
  ``Renderer.frame_params`` built (its inputs changed);
  ``transform_bakes``, the re-bakes of moved transforms
  (``refresh_transforms``); ``graph_key_builds``, the times
  ``Renderer._graph_key`` built the captured frame's key again (one of its
  parts changed); ``light_rows``, the light rows ``pack_scene`` packed
  (each prepare adds its scene's); ``light_rewrites``, the times
  ``refresh_lights`` wrote the light rows again (a light moved or
  changed with no spawn or despawn).
- ``snapshot()`` returns the counters, the kernels' launch counts
  (``kernels/_build.py`` ``LAUNCHES``, as ``launches.<kernel>``) and a
  copy of the span log.  The log grows while the spans are on;
  ``reset()`` empties it and zeroes the counters.

The spans of a frame (``App.render_frame``): ``frame`` > ``runtime_systems``,
``render``; ``render`` > ``render_device``, ``fetch``, ``check_overflow``;
on a card ``fetch`` > ``fetch_issue`` (the copy's issue), ``fetch_wait``
(the one wait, for the frame and its copy);
``render_device`` > ``sync_topology`` (> ``repack``, ``prepare``),
``refresh_transforms``, ``frame_params``, ``shadow_memo`` (>
``shadow_replay``), ``graph_lookup`` (the key and the staging; > ``capture``
on a miss), ``replay``, ``note_overflow``; on the CPU ``eager_frame`` (>
the ``pass::`` spans) in place of the lookup and the replay.  ``prepare`` >
``pack_scene`` (> ``pack_lights``), ``ibl_precompute`` (which synchronises
the device at its end while the spans are on, so its host time holds the
device's work).  A views call: ``render_views`` > ``sync_topology``, ``params``,
``graph_lookup``, ``replay``.

The tracer is one per process, for the thread that renders.
"""

from __future__ import annotations

import time

import torch

_on = False
_frame = 0
_log: list = []  # [name, parent, frame, start_ns, end_ns] per span
_open: list = []  # log indices of the open spans, innermost last
_counts: dict = {}


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def set_frame(frame: int) -> None:
    """The frame id of the spans opened from now on."""
    global _frame
    _frame = frame


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def reset() -> None:
    """Empty the span log and zero the counters (not the launches)."""
    _log.clear()
    _counts.clear()


def snapshot() -> dict:
    """{"counters": {name: int}, "spans": [(name, parent, frame, start_ns,
    end_ns)]}; the counters hold ``launches.<kernel>`` for each kernel."""
    from ..kernels import _build

    counters = dict(_counts)
    counters.update((f"launches.{k}", v) for k, v in _build.LAUNCHES.items())
    return {"counters": counters, "spans": [tuple(s) for s in _log]}


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()  # the span of every name while the tracer is off


class _Span:
    __slots__ = ("name", "index", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.index = len(_log)
        _log.append([self.name, _open[-1] if _open else None, _frame,
                     time.perf_counter_ns(), None])
        _open.append(self.index)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function("mo::" + self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _open.pop()
        _log[self.index][4] = time.perf_counter_ns()
        return False


def span(name: str):
    """A context that records the block as the span ``name`` (tracer on),
    or ``NULL``, which does nothing (off)."""
    if not _on:
        return NULL
    return _Span(name)
