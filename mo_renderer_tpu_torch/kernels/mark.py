"""Pass markers in a captured frame (``csrc/mark.cu``).

A replayed frame is one ``cudaGraphLaunch``, so a host range cannot split
it by pass.  ``pass_span(name)`` is the tracer's span ``pass::<name>``
(``utils/trace.py``) of one pass of a captured program.  With the tracer
on, while the current stream captures a CUDA graph, it also launches a
one-thread marker kernel, ``mo_mark_kernel<k>`` with k the pass's index in
``PASSES``, where the pass starts, and where it ends the marker of the pass
it returns to (``END`` after the outermost).  In the device trace of a
replay, every operation of a pass then lies between the pass's marker and
the next marker.  With the tracer off nothing is launched, so the captured
graph is the same as without the tracer.
"""

from __future__ import annotations

import torch

from ..utils import trace
from . import _build

# the passes of a captured program, in the order a frame runs them;
# "frame" is the program itself (what runs outside its passes)
PASSES = ("frame", "vertex stage", "shadow", "triangle setup", "binning",
          "raster", "decimate", "G-buffer", "SSAO", "shading",
          "render passes", "present")
END = len(PASSES)  # the marker after a captured program's last operation
# csrc/mark.cu's kMarks is END + 1

_open: list = []  # pass indices of the open marked passes, innermost last


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _launch(k: int) -> None:
    """``mo_mark_kernel<k>`` on the current stream."""
    fn = _build.function("mo_mark", [_build.I, _build.P])
    _build.check("mark", fn(k, torch.cuda.current_stream().cuda_stream))
    _build.count("mark")


class _PassSpan:
    __slots__ = ("span", "k", "marked")

    def __init__(self, name: str):
        self.span = trace.span("pass::" + name)
        self.k = PASSES.index(name)

    def __enter__(self):
        self.span.__enter__()
        self.marked = _capturing()
        if self.marked:
            _launch(self.k)
            _open.append(self.k)
        return self

    def __exit__(self, *exc):
        if self.marked:
            _open.pop()
            _launch(_open[-1] if _open else END)
        return self.span.__exit__(*exc)


def pass_span(name: str):
    """The span ``pass::<name>`` of the pass ``name`` of ``PASSES``, with
    its markers in a graph being captured; the tracer's shared no-op while
    it is off."""
    if not trace.enabled():
        return trace.NULL
    return _PassSpan(name)
