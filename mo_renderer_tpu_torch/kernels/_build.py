"""Build, load and call the CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all of
them started together, and the objects link into ONE shared library with a
plain C interface, loaded with ``ctypes``.  The build runs at first use
(never at import: the CPU tests import every module) into ``_build/``
beside this package, keyed by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads at once.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.  A
failed build raises too: nothing falls back to a plain version.

``LAUNCHES`` counts kernel launches per kernel name.  A wrapper adds one
right after its launch succeeded, and nowhere else; a replayed CUDA graph
adds the launches it captured (``passes/frame_graph.py``, ``_FrameGraph``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
# Multiply-add contraction, per unit.  -fmad=false is the rule: each kernel
# rounds once per operation exactly like its plain PyTorch twin (the
# rasterizer's exact-on-edge pixels, the SSAO hash noise and the G-buffer
# tail's texel index depend on it; where a kernel wants a fused multiply-add
# it calls fmaf explicitly).  The units listed here contract, and divide
# and take square roots to within 2 ulps instead of rounding them
# correctly: their results are continuous in the arithmetic, held to a
# tolerance, and each pins with __fmul_rn / __fadd_rn / __fsub_rn /
# __fdiv_rn / __fsqrt_rn every operation that feeds a compare or an
# integer (the headers of csrc/shading.cu and csrc/shading_ref.cu list
# them).
FMAD_DEFAULT = ("-fmad=false",)
_CONTRACT = ("-fmad=true", "-prec-div=false", "-prec-sqrt=false")
UNIT_FLAGS = {"shading.cu": _CONTRACT, "shading_ref.cu": _CONTRACT}


def unit_flags(unit: str) -> tuple:
    """The nvcc flags of one csrc/ unit."""
    return NVCC_FLAGS + UNIT_FLAGS.get(os.path.basename(unit), FMAD_DEFAULT)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

LAUNCHES: dict[str, int] = {
    "raster_slim": 0,
    "raster_depth": 0,
    "attr_planes": 0,
    "ssao": 0,
    "interleave": 0,
    "interleave_present": 0,
    "raster_full": 0,
    "raster_attrs": 0,
    "stack_planes": 0,
    "raster_slim_band": 0,
    "raster_depth_band": 0,
    "ssao_halo": 0,
    "shading": 0,
    "gbuffer": 0,
    "shading_ref": 0,
    "gbuffer_ref": 0,
    "mark": 0,
    "tri_setup": 0,
    "bin_count": 0,
    "bin_scan": 0,
    "bin_fill": 0,
}

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count(name: str, n: int = 1) -> None:
    """``n`` more launches of ``name``: one from a wrapper that launched,
    or a CUDA graph's captured launches of it, at each replay."""
    LAUNCHES[name] += n


def sources() -> list[str]:
    return sorted(
        glob.glob(os.path.join(CSRC, "*.cu"))
        + glob.glob(os.path.join(CSRC, "*.cuh"))
    )


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of mo_renderer_tpu_torch are "
        "built from csrc/*.cu with nvcc (set $NVCC or put it on PATH)"
    )


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr((FMAD_DEFAULT, sorted(UNIT_FLAGS.items()))).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmo_kernels-{h.hexdigest()[:16]}.so")


def _run_all(cmds) -> None:
    """Run the commands concurrently; raise with the output of the first
    that fails."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True))
        for cmd in cmds
    ]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(" ".join(cmd) + "\n" + out)
    if failed:
        raise RuntimeError(
            "nvcc failed building the CUDA kernels:\n" + "\n".join(failed)
        )


def build() -> str:
    """Compile csrc/*.cu into the shared library (if not built yet) and
    return its path.  Raises with nvcc's output when the build fails."""
    global build_seconds
    so = _library_path()
    if os.path.exists(so):
        if build_seconds is None:
            build_seconds = 0.0
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    units = [s for s in sources() if s.endswith(".cu")]
    objs = [
        os.path.join(BUILD_DIR, f"{os.path.basename(u)}.{tag}.o")
        for u in units
    ]
    t0 = time.perf_counter()
    try:
        _run_all([
            [nvcc, *unit_flags(u), "-c", "-o", o, u]
            for u, o in zip(units, objs)
        ])
        tmp = f"{so}.{tag}"
        _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    return so


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.mo_error_string.restype = ctypes.c_char_p
            lib.mo_error_string.argtypes = [I]
            _lib = lib
    return _lib


def function(name: str, argtypes) -> ctypes._CFuncPtr:
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = I
    return fn


def check(name: str, err: int) -> None:
    if err != 0:
        msg = library().mo_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {err} ({msg})")


def stream_of(t) -> int:
    """The current PyTorch CUDA stream on ``t``'s device, as a pointer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


INT32_MAX = 2 ** 31 - 1


def max_offset(t) -> int:
    """The largest element offset within ``t`` from its first element:
    what a kernel that indexes it with 32-bit offsets must reach."""
    return sum((n - 1) * abs(st) for n, st in zip(t.shape, t.stride()))


def require_cuda(name: str, *tensors, dtypes=None) -> None:
    """Wrapper-side checks before a launch: every tensor on one CUDA
    device, contiguous, and of the expected dtype."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(
                f"{name}: argument {i} is on {t.device}, expected {dev}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
        if dtypes is not None and t.dtype != dtypes[i]:
            raise TypeError(
                f"{name}: argument {i} has dtype {t.dtype}, "
                f"expected {dtypes[i]}"
            )
