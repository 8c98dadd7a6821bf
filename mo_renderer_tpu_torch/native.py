"""ctypes bindings for the native data-loader (native/mo_native.cpp).

The shared library is built lazily with g++ on first use and cached in
$MO_CACHE_DIR (default: the package's gitignored ``_build/``) keyed by the
source hash; if no toolchain is available every caller falls back to its
pure-Python implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess

import numpy as np

logger = logging.getLogger("mo_renderer_tpu_torch")

_SRC = os.path.join(os.path.dirname(__file__), "..", "native", "mo_native.cpp")
_lib = None
_tried = False


def _cache_dir() -> str:
    d = os.environ.get(
        "MO_CACHE_DIR", os.path.join(os.path.dirname(__file__), "_build")
    )
    os.makedirs(d, exist_ok=True)
    return d


def _build() -> ctypes.CDLL | None:
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
    except OSError:
        return None
    so_path = os.path.join(
        _cache_dir(), f"mo_native-{hashlib.sha1(src).hexdigest()[:12]}.so"
    )
    if not os.path.exists(so_path):
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", so_path, _SRC],
                check=True, capture_output=True, timeout=120,
            )
            logger.info("built native data-loader: %s", so_path)
        except (OSError, subprocess.SubprocessError) as e:
            logger.info("native build unavailable (%s); using Python paths", e)
            return None
    lib = ctypes.CDLL(so_path)
    lib.mo_hdr_dims.restype = ctypes.c_int
    lib.mo_hdr_dims.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.mo_hdr_decode.restype = ctypes.c_int
    lib.mo_hdr_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.mo_pack_quads.restype = None
    lib.mo_pack_quads.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def get_lib() -> ctypes.CDLL | None:
    global _lib, _tried
    if not _tried:
        _tried = True
        if os.environ.get("MO_NO_NATIVE"):
            _lib = None
        else:
            _lib = _build()
    return _lib


def hdr_decode_rgbe(data: bytes) -> np.ndarray | None:
    """Radiance .hdr bytes -> (H, W, 4) uint8 RGBE, or None (fallback)."""
    lib = get_lib()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    off = ctypes.c_long()
    rc = lib.mo_hdr_dims(data, len(data), ctypes.byref(w),
                         ctypes.byref(h), ctypes.byref(off))
    if rc != 0:
        return None
    out = np.empty((h.value, w.value, 4), np.uint8)
    rc = lib.mo_hdr_decode(
        data, len(data), off.value, w.value, h.value,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        return None
    return out


def pack_quads_u32(rgba: np.ndarray) -> np.ndarray | None:
    """(S, S, 4) uint8 -> (S*S, 4) uint32 REPEAT quads, or None."""
    lib = get_lib()
    if lib is None:
        return None
    s = rgba.shape[0]
    if rgba.shape != (s, s, 4) or rgba.dtype != np.uint8:
        return None
    rgba = np.ascontiguousarray(rgba)
    out = np.empty((s * s, 4), np.uint32)
    lib.mo_pack_quads(
        rgba.ctypes.data_as(ctypes.c_void_p), s,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out
