"""Core utilities (mo_core/src/utils.rs) and profiling helpers (port of
``mo_renderer_tpu/utils/__init__.py``).

The reference's tracing is the ``tracing`` crate's spans and INFO
milestones.  Here the milestones go to the ``mo_renderer_tpu_torch``
logger, and the spans and counters to the port's tracer (``trace``):
spans off by default, each recorded in memory as ``(name, parent, frame,
start_ns, end_ns)`` on the host clock while on, counters (full
prepares, kernel launches) always on; ``trace.snapshot()`` returns both.
``profile_trace`` (what ``App.run(profile_dir=...)`` takes) records a
``torch.profiler`` trace of its block with the tracer on: the spans show in it as ``mo::<name>``
ranges on the profiler's clock, and each pass of a replayed frame lies
between its marker kernels (``mo_mark_kernel<k>``, pass k of
``kernels/mark.py``'s ``PASSES``).

The JAX package's ``enable_compile_cache`` points XLA's persistent
compilation cache at ``$MO_CACHE_DIR``.  The port compiles nothing per
frame configuration: its one compiled artefact is the CUDA kernels'
shared library, which ``kernels/_build.py`` builds with nvcc into its
build directory at first launch and reuses from there.  So it has no
counterpart here.
"""

from __future__ import annotations

import contextlib
import logging
import os

from . import trace

logger = logging.getLogger("mo_renderer_tpu_torch")


def clamp(value, min_value, max_value):
    """mo_core/src/utils.rs:1-18."""
    if value < min_value:
        return min_value
    if value > max_value:
        return max_value
    return value


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler over the block (CPU and, on a card, CUDA activity),
    written to ``log_dir`` as a Chrome trace (TensorBoard's layout), with
    the tracer on over the block (and as it was after it).  Turning the
    tracer on keys the captured frame anew, so the block's first frame
    captures once, with the pass markers."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = trace.enabled()
    trace.enable()
    try:
        with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
        ):
            yield
    finally:
        if not was_on:
            trace.disable()
