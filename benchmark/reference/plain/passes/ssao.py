"""SSAO pass: the radius-quantized depth-only ambient occlusion of
``mo_renderer_tpu/passes/ssao.py`` (a port of the reference's ssao.comp).

``ssao_pass_tiles`` is the port of ``ssao_pass_pallas`` (K4); its CUDA
kernel is ``csrc/ssao.cu``.  With ``y_halo`` (K4b) it is one band of a
row-sharded frame: real depth rows of the neighbouring bands replace the
edge clamp above and below the band, so the band's AO equals the same rows
of the whole-image pass.  ``ssao_pass`` (``EngineConfig.ssao_pallas``
off) computes the same radius-quantized AO as whole-image torch ops, and
``ssao_pass_exact`` is the tests' tap-for-tap oracle.  Per pixel: hash noise from the global pixel
coordinate, a radius level out of 16 geometric levels, then the
fade-weighted sum of depth compares over that level's 18 integer taps,
read from the edge-clamped image, in tap order.  AO = 1 - sum/3,
quantized to k/255.

Arithmetic follows the reference as it evaluates on the CPU, where XLA
fuses three multiply-adds: the linear depth's ``far + near - d*(far-near)``,
the noise argument ``px*12.9898 + py*78.233`` and the radius's
``... + nx*(1-nx)``.  The kernel calls ``fmaf`` at exactly those places;
the plain version computes the same single-rounded results in float64
(exact for these operand ranges).  The noise argument reaches ~1e5
radians and the 43758x amplification turns one ulp of it into a new noise
value, so it must match exactly.  XLA also turns each division by a
constant (by 60/(far-near), by the total fade 3 and by 255) into a
multiply by the float32 reciprocal; both versions here do the same.
``sin`` is evaluated in float64 and rounded once on both sides; f32
``sin`` implementations differ by an ulp (the reference's on ~1% of
pixels), which moves the radius by up to ~0.02 px.  The remaining
divisions (by the depth) are true divisions in the plain version too
(``_div``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


NEAR = 0.1
FAR = 100.0
NUM_LEVELS = 16

# The CUDA kernel's output tile is TILE_H x TILE_W pixels (csrc/ssao.cu
# kTileH, kTileW): ``_tables`` builds the tap offsets for a window that wide.
TILE_H = 32
TILE_W = 32

NUM_RINGS = 3
NUM_SAMPLES = 6
_TAPS = []
_fade = 1.0
for _i in range(NUM_RINGS):
    _fade *= 0.5
    for _j in range(NUM_SAMPLES * _i):
        _step = 2.0 * np.pi / (NUM_SAMPLES * _i)
        _TAPS.append((np.cos(_j * _step) * _i, np.sin(_j * _step) * _i, _fade))
_TOTAL = sum(f for _, _, f in _TAPS)

_F32 = np.float32


def _fma(a, b, c):
    """a*b + c rounded once to float32, via float64 (exact when the
    float64 product and sum are exact, as at every call site here)."""
    return (a.double() * b + c.double()).float()


def _div(c: float, t):
    """c / t as a true division (PyTorch evaluates ``c / t`` as
    ``c * (1 / t)``, which rounds twice)."""
    return torch.full_like(t, c) / t


def _linear_depth(d, near=NEAR, far=FAR):
    """ssao.comp:22-24: 2n / (f + n - d (f - n))."""
    denom = _fma(
        -d, float(_F32(far - near)), torch.full_like(d, float(_F32(far + near)))
    )
    return _div(2.0 * near, denom)


def _recip(c: float) -> float:
    """The float32 reciprocal of float32(c), as XLA folds ``x / c``."""
    return float(_F32(1.0) / _F32(c))


def _compare_depths(d1, d2, near=NEAR, far=FAR):
    """ssao.comp:26-34."""
    diff = torch.sqrt(torch.clamp(
        1.0 - (d1 - d2) * _recip(60.0 / (far - near)), 0.0, 1.0
    ))
    return torch.clamp(
        torch.clamp(d1 - d2 - 0.001, min=0.0) * 50.0, max=0.5
    ) * diff


def _noise(px, py, sx=12.9898, sy=78.233):
    """One component of generateRandomNoise (ssao.comp:15-20):
    fract(sin(px*sx + py*sy) * 43758.5453) * 0.004; (sx, sy) doubled
    gives the y component."""
    arg = _fma(px, float(_F32(sx)), py * sy)
    v = torch.sin(arg.double()).float() * 43758.5453
    return (v - torch.floor(v)) * 0.004


def _radius(d_c, n, size):
    """((1/size) / d_c + n (1 - n)) * (size / 2): one axis of the sample
    radius in pixels (ssao.comp:97-101)."""
    return _fma(n, (1.0 - n).double(), _div(1.0 / size, d_c)) * (size / 2.0)


def _radii(d_lin, w, h, row_offset=0):
    """Per-pixel sample radii (rw, rh) in pixels (ssao.py:80); the noise
    takes the global row ``iy + row_offset``."""
    hh, ww = d_lin.shape
    dev = d_lin.device
    iy = (torch.arange(hh, device=dev)[:, None] + row_offset).expand(hh, ww)
    ix = torch.arange(ww, device=dev)[None, :].expand(hh, ww)
    px, py = ix.to(torch.float32), iy.to(torch.float32)
    d_c = torch.clamp(d_lin, 0.05, 1.0)
    return (_radius(d_c, _noise(px, py), w),
            _radius(d_c, _noise(px, py, 12.9898 * 2.0, 78.233 * 2.0), h))


def _ssao_tap_table(w: int, num_levels: int = NUM_LEVELS):
    """(edges, per-level integer tap offsets, max |offset|) — the
    reference's table, built on the host."""
    r_lo, r_hi = 0.5, 10.0 + 0.004 * (1 - 0.004) * (w / 2.0)
    edges = np.geomspace(r_lo, r_hi, num_levels + 1)
    centers = np.sqrt(edges[:-1] * edges[1:])
    level_taps = []
    max_off = 0
    for k in range(num_levels):
        taps_k = []
        for sw, sh, fade in _TAPS:
            ox = int(np.trunc(sw * float(centers[k])))
            oy = int(np.trunc(sh * float(centers[k])))
            taps_k.append((ox, oy, fade))
            max_off = max(max_off, abs(ox), abs(oy))
        level_taps.append(taps_k)
    return edges, level_taps, max_off


def ssao_halo_rows(w: int, num_levels: int = NUM_LEVELS) -> int:
    """Rows of neighbouring depth a band needs on each side (ssao.py:164):
    the largest tap offset, rounded up to 8 as the reference rounds it."""
    return -(-_ssao_tap_table(w, num_levels)[2] // 8) * 8


class _Tables(NamedTuple):
    offs: torch.Tensor  # (levels, taps, 2) int32: ox, oy
    fades: torch.Tensor  # (taps,) f32
    edges: torch.Tensor  # (levels - 1,) f32, the inner level edges
    max_off: int  # the halo: max |offset|
    win_offs: torch.Tensor  # (levels, taps) int32: oy * win_w + ox
    win_w: int  # TILE_W + 2 * max_off, the kernel's window width


@functools.lru_cache(maxsize=16)
def _tables(w, num_levels, device):
    """Tap offsets, fades and level edges as tensors on ``device``, made
    once per (width, levels, device): a host-to-device copy per call
    would stall the launch queue every frame.  ``win_offs`` are
    the same offsets as flat steps inside the kernel's shared window of
    linear depth, ``win_w`` values wide."""
    edges, level_taps, max_off = _ssao_tap_table(w, num_levels)
    offs = torch.tensor(
        [[(ox, oy) for ox, oy, _ in lt] for lt in level_taps],
        dtype=torch.int32, device=device,
    )  # (levels, taps, 2)
    fades = torch.tensor(
        [f for _, _, f in level_taps[0]], dtype=torch.float32, device=device
    )
    edges_in = torch.tensor(
        edges[1:-1].astype(np.float32), dtype=torch.float32, device=device
    )
    win_w = TILE_W + 2 * max_off
    win_offs = (offs[..., 1] * win_w + offs[..., 0]).contiguous()
    return _Tables(offs, fades, edges_in, max_off, win_offs, win_w)


def ssao_pass_tiles(depth, num_levels: int = NUM_LEVELS, row_offset: int = 0,
                    near=NEAR, far=FAR, y_halo=None):
    """depth (H, W) raw [0, 1] -> AO (H, W) in k/255.  ``W`` is the width
    the radius formula uses: pass the padded plane exactly as the frame
    pads it (the reference pads the even grid to tile multiples first).

    A band of a row-sharded frame passes its first row in the frame as
    ``row_offset`` (the hash noise) and ``y_halo = (top, bottom)``: the
    ``ssao_halo_rows(W)`` rows of raw depth above and below the band (the
    frame's outer bands replicate their edge row); None clamps at the
    plane's edge."""
    if y_halo is not None:
        _check_halo(depth, y_halo, num_levels)
    return _ssao_plain(depth, num_levels, row_offset, near, far, y_halo)


def _check_halo(depth, y_halo, num_levels):
    top, bottom = y_halo
    want = (ssao_halo_rows(depth.shape[1], num_levels), depth.shape[1])
    if tuple(top.shape) != want or tuple(bottom.shape) != want:
        raise ValueError(
            f"ssao: halo planes must be {want} (ssao_halo_rows rows), got "
            f"{tuple(top.shape)} and {tuple(bottom.shape)}"
        )


def _ssao_plain(depth, num_levels, row_offset, near, far, y_halo=None):
    h, w = depth.shape
    dev = depth.device
    offs, fades, edges = _tables(w, num_levels, dev)[:3]
    # the taps read the band with its halo rows above and below, clamped
    # at the edge of that taller plane
    above, plane = 0, depth
    if y_halo is not None:
        above = y_halo[0].shape[0]
        plane = torch.cat([y_halo[0], depth, y_halo[1]])
    d_all = _linear_depth(plane, near, far)
    d_lin = d_all[above: above + h]
    iy = torch.arange(h, device=dev)[:, None].expand(h, w)
    ix = torch.arange(w, device=dev)[None, :].expand(h, w)
    rw, _ = _radii(d_lin, w, h, row_offset)
    lvl = (rw[..., None] > edges).sum(-1)
    ao = None
    for t in range(offs.shape[1]):
        o = offs[lvl, t].to(torch.int64)
        sy = torch.clamp(iy + above + o[..., 1], 0, plane.shape[0] - 1)
        sx = torch.clamp(ix + o[..., 0], 0, w - 1)
        c = _compare_depths(d_lin, d_all[sy, sx], near, far) * fades[t]
        ao = c if ao is None else ao + c
    return _quantized_ao(ao)


def _quantized_ao(ao):
    """1 - ao / total fade, clamped and quantized to k/255."""
    ao = 1.0 - ao * _recip(_TOTAL)
    return torch.round(torch.clamp(ao, 0.0, 1.0) * 255.0) * _recip(255.0)


def ssao_pass(depth, num_levels: int = NUM_LEVELS, near=NEAR, far=FAR):
    """The radius-quantized SSAO as whole-image torch ops (ssao.py:92;
    ``EngineConfig.ssao_pallas=False``): per radius level, the sum of its
    taps' depth compares against the edge-clamped shifted image (one
    compare per unique integer offset, shared across levels); each pixel
    keeps its level's sum.  Same semantics as the tile kernel, without
    the row offset.  depth (H, W) raw [0, 1] -> AO (H, W) in k/255."""
    h, w = depth.shape
    dev = depth.device
    d_lin = _linear_depth(depth, near, far)
    rw, _ = _radii(d_lin, w, h)
    _, level_taps, _ = _ssao_tap_table(w, num_levels)
    lvl = torch.searchsorted(_tables(w, num_levels, dev).edges,
                             rw.contiguous())
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    cache = {}

    def compare_at(ox, oy):
        # the reference edge-pads d_lin and slices; an index clamp reads
        # the same values
        if (ox, oy) not in cache:
            shifted = d_lin[torch.clamp(ys + oy, 0, h - 1)][
                :, torch.clamp(xs + ox, 0, w - 1)
            ]
            cache[(ox, oy)] = _compare_depths(d_lin, shifted, near, far)
        return cache[(ox, oy)]

    ao = torch.zeros_like(d_lin)
    for k in range(num_levels):
        ao_k = None
        for ox, oy, fade in level_taps[k]:
            c = compare_at(ox, oy) * fade
            ao_k = c if ao_k is None else ao_k + c
        ao = torch.where(lvl == k, ao_k, ao)
    return _quantized_ao(ao)


def ssao_pass_exact(depth, near=NEAR, far=FAR):
    """The direct tap-for-tap port of ssao.comp (ssao.py:296): unquantized
    per-pixel radii on both axes.  The numeric oracle of the tests."""
    h, w = depth.shape
    dev = depth.device
    d_lin = _linear_depth(depth, near, far)
    rw, rh = _radii(d_lin, w, h)
    iy = torch.arange(h, device=dev)[:, None]
    ix = torch.arange(w, device=dev)[None, :]
    ao = torch.zeros_like(d_lin)
    for sw, sh, fade in _TAPS:
        ox = torch.trunc(float(sw) * rw).to(torch.int64)
        oy = torch.trunc(float(sh) * rh).to(torch.int64)
        sy = torch.clamp(iy + oy, 0, h - 1)
        sx = torch.clamp(ix + ox, 0, w - 1)
        ao = ao + _compare_depths(d_lin, d_lin[sy, sx], near, far) * fade
    return _quantized_ao(ao)


