"""Core utilities (mo_core/src/utils.rs) and profiling helpers (port of
``mo_renderer_tpu/utils/__init__.py``).

The reference's tracing is the ``tracing`` crate's sparse INFO milestones;
here it is the ``mo_renderer_tpu_torch`` logger (``log_span``) and an
optional ``torch.profiler`` trace around the frame loop
(``profile_trace``, what ``App.run(profile_dir=...)`` takes).

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
import time

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
    written to ``log_dir`` as a Chrome trace (TensorBoard's layout)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield


@contextlib.contextmanager
def log_span(name: str, logger: logging.Logger | None = None):
    """Log a timed span at INFO (the tracing-span analog)."""
    log = logger or logging.getLogger("mo_renderer_tpu_torch")
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log.info("%s: %.1f ms", name, (time.perf_counter() - t0) * 1e3)
