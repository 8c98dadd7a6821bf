"""Texture sampling (port of ``mo_renderer_tpu/device/sampling.py``): the
reference samplers of the reference sampling path, and the packed layouts
of the fast path and the IBL precompute.

Conventions follow GLSL ``texture()``: texel centres at (i + 0.5) / N,
cube faces ordered +X,-X,+Y,-Y,+Z,-Z with the GL coordinate rules, mip
chains packed flat so per-pixel LOD selection is integer offset math.

Packed values (RGBE texels, u16 PCF windows, RGBA8 texture quads) are
held as int32 bit patterns: torch's uint32 supports few operations, and
right shifts on int32 sign-extend, so every shift is followed by a mask.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CLAMP_TO_EDGE = 0
REPEAT = 1


def take_rows(table, idx):
    """Row gather ``table[idx]`` for in-bounds indices."""
    return table[idx.to(torch.int64)]


def wrap_index(i, n: int, mode: int):
    if mode == REPEAT:
        return torch.remainder(i, n)
    return torch.clamp(i, 0, n - 1)


def _gather2d(tex, iy, ix):
    """tex (H, W, C); iy/ix int (...,) -> (..., C)."""
    h, w, c = tex.shape
    return take_rows(tex.reshape(h * w, c), iy * w + ix)


def _bilerp(t00, t10, t01, t11, fx, fy):
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def _floor_fract(uv, h: int, w: int):
    """Texel-centre coordinates of uv: (x0, y0) int32 and (fx, fy) (..., 1)."""
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return (x0.to(torch.int32), y0.to(torch.int32),
            (x - x0)[..., None], (y - y0)[..., None])


def sample_bilinear(tex, uv, mode: int = CLAMP_TO_EDGE):
    """GLSL-style bilinear sample; tex (H, W, C), uv (..., 2) -> (..., C)."""
    h, w, _ = tex.shape
    x0i, y0i, fx, fy = _floor_fract(uv, h, w)
    x0w, x1w = wrap_index(x0i, w, mode), wrap_index(x0i + 1, w, mode)
    y0w, y1w = wrap_index(y0i, h, mode), wrap_index(y0i + 1, h, mode)
    return _bilerp(
        _gather2d(tex, y0w, x0w), _gather2d(tex, y0w, x1w),
        _gather2d(tex, y1w, x0w), _gather2d(tex, y1w, x1w), fx, fy,
    )


def sample_array_bilinear(tex_array, layer, uv, mode: int = CLAMP_TO_EDGE):
    """Bilinear sample from a texture array (the bindless analog).

    tex_array (L, S, S, C), uint8 (unorm, scaled by 1/255) or float;
    layer int (...,); uv (..., 2) -> (..., C) f32."""
    n_layers, h, w, c = tex_array.shape
    x0i, y0i, fx, fy = _floor_fract(uv, h, w)
    x0w, x1w = wrap_index(x0i, w, mode), wrap_index(x0i + 1, w, mode)
    y0w, y1w = wrap_index(y0i, h, mode), wrap_index(y0i + 1, h, mode)
    flat = tex_array.reshape(n_layers * h * w, c)
    base = layer.to(torch.int32) * (h * w)

    def tap(iy, ix):
        v = take_rows(flat, base + iy * w + ix)
        if tex_array.dtype == torch.uint8:
            v = v.to(torch.float32) * (1.0 / 255.0)
        return v

    return _bilerp(tap(y0w, x0w), tap(y0w, x1w), tap(y1w, x0w),
                   tap(y1w, x1w), fx, fy)


# --- PCF window tables --------------------------------------------------------
#
# Three layouts (EngineConfig.pcf_u16 / pcf_half_anchor), told apart by
# shading.calculate_shadow_fast from the dtype and the row count: f32
# 2x4 wide rows (two gathers per pixel), u16 4x4 windows at every texel,
# u16 4x4 windows at every even texel (the default).

def _shift_rows(t, k):
    """t[y + k] with the last row repeated past the edge."""
    return t if k == 0 else torch.cat([t[k:], t[-1:].expand(k, -1)], dim=0)


def _shift_cols(t, k):
    """t[:, x + k] with the last column repeated past the edge."""
    return t if k == 0 else torch.cat([t[:, k:], t[:, -1:].expand(-1, k)],
                                      dim=1)


def build_window_rows_2x4(img):
    """(H, W) -> (H*W, 8) f32 rows [t(y, x..x+3), t(y+1, x..x+3)],
    edge-clamped (sampling.py:374): two rows, at y-1 and y+1, column x-1,
    hold the 4x4 PCF neighbourhood of texel (y, x)."""
    down = _shift_rows(img, 1)
    cols = ([_shift_cols(img, k) for k in range(4)]
            + [_shift_cols(down, k) for k in range(4)])
    return torch.stack(cols, dim=-1).reshape(-1, 8)


def _quantize_u16(img):
    """Depth -> 16-bit unorm, rounded up (int32)."""
    return torch.clamp(
        torch.ceil(torch.clamp(img, 0.0, 1.0) * 65535.0), max=65535.0
    ).to(torch.int32)


def build_pcf_window_u16(img):
    """(S, S) depth -> (S*S, 8) int32: texel (y, x)'s 4x4 window (rows
    y..y+3, cols x..x+3, edge-clamped) of ceil-quantized 16-bit depth,
    packed two texels per word in row-major pairs (sampling.py:403)."""
    q = _quantize_u16(img)
    vals = [_shift_cols(_shift_rows(q, r), c)
            for r in range(4) for c in range(4)]
    packed = [vals[2 * j] | (vals[2 * j + 1] << 16) for j in range(8)]
    return torch.stack(packed, dim=-1).reshape(-1, 8)


def build_pcf_window_u16_half(img):
    """(S, S) depth -> ((S/2)^2, 8) int32: the 4x4 window of 16-bit
    ceil-quantized depth anchored at every EVEN texel (rows 2i..2i+3,
    cols 2j..2j+3, edge-clamped), packed two texels per word in row-major
    pairs (sampling.py:440)."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    q = _quantize_u16(img)
    q = torch.cat([q, q[:, -1:].expand(-1, 2)], dim=1)
    q = torch.cat([q, q[-1:].expand(2, -1)], dim=0)
    vals = []
    for r in range(4):
        for c in range(4):
            vals.append(q[r : r + 2 * h2 : 2, c : c + 2 * w2 : 2])
    packed = [vals[2 * j] | (vals[2 * j + 1] << 16) for j in range(8)]
    return torch.stack(packed, dim=-1).reshape(-1, 8)


# --- cube maps ----------------------------------------------------------------

def cube_direction(face: int, uv):
    """Face + uv -> direction, the reference's getDirection table."""
    u = uv[..., 0] * 2.0 - 1.0
    v = uv[..., 1] * 2.0 - 1.0
    one = torch.ones_like(u)
    return [
        lambda: torch.stack([one, -v, -u], -1),
        lambda: torch.stack([-one, -v, u], -1),
        lambda: torch.stack([u, one, v], -1),
        lambda: torch.stack([u, -one, -v], -1),
        lambda: torch.stack([u, -v, one], -1),
        lambda: torch.stack([-u, -v, -one], -1),
    ][face]()


def cube_face_uv(dirs):
    """Direction (..., 3) -> (face int, u, v): the GL cube sampling rule."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(
        is_x,
        torch.where(x >= 0, 0, 1),
        torch.where(
            is_y, torch.where(y >= 0, 2, 3), torch.where(z >= 0, 4, 5)
        ),
    ).to(torch.int32)
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    ma = torch.clamp(ma, min=1e-20)
    sc = torch.where(
        is_x,
        torch.where(x >= 0, -z, z),
        torch.where(is_y, x, torch.where(z >= 0, x, -x)),
    )
    tc = torch.where(is_y, torch.where(y >= 0, z, -z), -y)
    u = 0.5 * (sc / ma + 1.0)
    v = 0.5 * (tc / ma + 1.0)
    return face, u, v


def sample_cubemap(faces, dirs):
    """Bilinear cubemap sample (clamped at face edges, no seam blending).
    faces (6, S, S, C); dirs (..., 3) -> (..., C)."""
    _, s, _, c = faces.shape
    face, u, v = cube_face_uv(dirs)
    x0, y0, fx, fy = _floor_fract(torch.stack([u, v], dim=-1), s, s)
    x0i, x1i = torch.clamp(x0, 0, s - 1), torch.clamp(x0 + 1, 0, s - 1)
    y0i, y1i = torch.clamp(y0, 0, s - 1), torch.clamp(y0 + 1, 0, s - 1)
    flat = faces.reshape(6 * s * s, c)
    base = face * (s * s)

    def tap(iy, ix):
        return take_rows(flat, base + iy * s + ix)

    return _bilerp(tap(y0i, x0i), tap(y0i, x1i), tap(y1i, x0i),
                   tap(y1i, x1i), fx, fy)


def bilinear_weights(uv, h: int, w: int, mode: int = CLAMP_TO_EDGE):
    """uv (..., 2) -> (row_index, fx, fy) for quad rows."""
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    if mode == CLAMP_TO_EDGE:
        fx = torch.where(x0 < 0, 0.0, fx)
        fy = torch.where(y0 < 0, 0.0, fy)
    x0i = wrap_index(x0.to(torch.int32), w, mode)
    y0i = wrap_index(y0.to(torch.int32), h, mode)
    return y0i * w + x0i, fx, fy


def build_quad_rows(tex):
    """(H, W, C) -> (H*W, 4*C) clamped quad rows: row (y*W + x) =
    [t(y,x), t(y,x+1), t(y+1,x), t(y+1,x+1)]."""
    h, w, c = tex.shape
    xs = torch.cat([tex[:, 1:], tex[:, -1:]], dim=1)
    ys = torch.cat([tex[1:], tex[-1:]], dim=0)
    xys = torch.cat([xs[1:], xs[-1:]], dim=0)
    return torch.cat([tex, xs, ys, xys], dim=-1).reshape(h * w, 4 * c)


# --- RGBE shared-exponent packing ---------------------------------------------

def pack_rgbe(rgb):
    """(..., 3) f32 >= 0 -> (...,) int32 RGBE bits (R | G<<8 | B<<16 | E<<24)."""
    m = rgb.amax(-1)
    e = torch.floor(torch.log2(torch.clamp(m, min=1e-32))) + 1.0
    scale = torch.exp2(-e) * 256.0
    mant = torch.clamp(
        torch.floor(rgb * scale[..., None]), 0.0, 255.0
    ).to(torch.int64)
    exp = torch.clamp(e.to(torch.int64) + 128, 1, 255)
    packed = mant[..., 0] | (mant[..., 1] << 8) | (mant[..., 2] << 16) | (
        exp << 24
    )
    packed = torch.where(m > 0.0, packed, 0)
    # uint32 bit pattern -> int32 (two's complement)
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)


def unpack_rgbe(v):
    """(...,) int32 RGBE bits -> (..., 3) f32."""
    e = (v >> 24) & 0xFF
    scale = torch.where(
        e > 0, torch.exp2(e.to(torch.float32) - 128.0 - 8.0), 0.0
    )
    rgb = torch.stack(
        [((v >> s) & 0xFF).to(torch.float32) + 0.5 for s in (0, 8, 16)], dim=-1
    )
    return rgb * scale[..., None]


def quad_lerp_rgbe(quad, fx, fy):
    """quad (..., 4) RGBE bits -> bilinear (..., 3)."""
    t00 = unpack_rgbe(quad[..., 0])
    t10 = unpack_rgbe(quad[..., 1])
    t01 = unpack_rgbe(quad[..., 2])
    t11 = unpack_rgbe(quad[..., 3])
    fx = fx[..., None]
    fy = fy[..., None]
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def build_cube_quad_rows_rgbe(faces):
    """(6, S, S, 3) HDR cube -> (6*S*S, 4) RGBE quad rows (int32 bits)."""
    packed = pack_rgbe(faces[..., :3])
    return torch.cat(
        [build_quad_rows(packed[f][..., None]) for f in range(6)], dim=0
    )


# --- mip chains -----------------------------------------------------------------

@dataclasses.dataclass
class MipCube:
    """A cubemap mip chain in one flat texel buffer: mip m occupies rows
    ``offsets[m] : offsets[m] + 6*sizes[m]^2`` (face-major, row-major)."""

    data: torch.Tensor  # (total_texels, C)
    sizes: np.ndarray  # (levels,) int32, host
    offsets: np.ndarray  # (levels,) int32, host

    @classmethod
    def from_mips(cls, mips):
        sizes = np.array([m.shape[1] for m in mips], dtype=np.int32)
        offsets = np.concatenate(
            [[0], np.cumsum(6 * sizes.astype(np.int64) ** 2)[:-1]]
        ).astype(np.int32)
        c = mips[0].shape[-1]
        data = torch.cat([m.reshape(-1, c) for m in mips], dim=0)
        return cls(data, sizes, offsets)

    @property
    def num_levels(self) -> int:
        return len(self.sizes)

    def level(self, m: int):
        s, o = int(self.sizes[m]), int(self.offsets[m])
        return self.data[o : o + 6 * s * s].reshape(6, s, s, -1)


@dataclasses.dataclass
class MipCubeQuad:
    """RGBE quad-packed cubemap mip chain, indexed like MipCube."""

    rows: torch.Tensor  # (total_texels, 4) int32 RGBE bits
    sizes: np.ndarray
    offsets: np.ndarray

    @classmethod
    def from_mipcube(cls, mc: MipCube):
        rows = torch.cat(
            [build_cube_quad_rows_rgbe(mc.level(m))
             for m in range(mc.num_levels)],
            dim=0,
        )
        return cls(rows, mc.sizes, mc.offsets)

    @property
    def num_levels(self) -> int:
        return len(self.sizes)


@dataclasses.dataclass
class MipCubeQuadMerged:
    """Child+parent RGBE quad pairs: ``rows[i]`` = [mip l's quad at texel
    i, mip l+1's quad at (y>>1, x>>1)]; the last mip pairs with itself
    (sampling.py:616)."""

    rows: torch.Tensor  # (total_texels, 8) int32 RGBE bits
    sizes: np.ndarray
    offsets: np.ndarray

    @classmethod
    def from_quad(cls, quad: MipCubeQuad):
        nl = quad.num_levels
        parts = []
        for lvl in range(nl):
            s, off = int(quad.sizes[lvl]), int(quad.offsets[lvl])
            child = quad.rows[off : off + 6 * s * s]
            p = min(lvl + 1, nl - 1)
            sp, offp = int(quad.sizes[p]), int(quad.offsets[p])
            par = quad.rows[offp : offp + 6 * sp * sp].reshape(6, sp, sp, 4)
            if sp != s:
                r = s // sp
                par = par.repeat_interleave(r, dim=1).repeat_interleave(
                    r, dim=2
                )
            parts.append(torch.cat([child, par.reshape(6 * s * s, 4)], dim=1))
        return cls(torch.cat(parts, dim=0), quad.sizes, quad.offsets)

    @property
    def num_levels(self) -> int:
        return len(self.sizes)


def _sample_mipcube_level(data, sizes, offsets, level, face, u, v):
    """Bilinear sample at per-pixel integer mip ``level``; sizes/offsets
    are device int tensors."""
    lv = level.to(torch.int64)
    s = sizes[lv]
    off = offsets[lv]
    sf = s.to(torch.float32)
    x = u * sf - 0.5
    y = v * sf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.minimum(torch.clamp(x0.to(torch.int32), min=0), s - 1)
    x1i = torch.minimum(torch.clamp(x0.to(torch.int32) + 1, min=0), s - 1)
    y0i = torch.minimum(torch.clamp(y0.to(torch.int32), min=0), s - 1)
    y1i = torch.minimum(torch.clamp(y0.to(torch.int32) + 1, min=0), s - 1)
    base = off + face * s * s

    def tap(iy, ix):
        return take_rows(data, base + iy * s + ix)

    return _bilerp(tap(y0i, x0i), tap(y0i, x1i), tap(y1i, x0i),
                   tap(y1i, x1i), fx, fy)


def sample_mipcube_lod(mipcube: "MipCube", dirs, lod):
    """GLSL textureLod on a cubemap: trilinear between mip levels.
    dirs (..., 3); lod (...,) -> (..., C)."""
    sizes, offsets = _level_tables(mipcube, dirs.device)
    nl = mipcube.num_levels
    face, u, v = cube_face_uv(dirs)
    lod = torch.clamp(lod, 0.0, nl - 1)
    l0 = torch.floor(lod).to(torch.int32)
    l1 = torch.clamp(l0 + 1, max=nl - 1)
    f = (lod - l0.to(lod.dtype))[..., None]
    c0 = _sample_mipcube_level(mipcube.data, sizes, offsets, l0, face, u, v)
    c1 = _sample_mipcube_level(mipcube.data, sizes, offsets, l1, face, u, v)
    return c0 * (1 - f) + c1 * f


def mipcube_quad_index_anchor(sizes, offsets, level, face, u, v):
    """Quad-row index, bilinear fractions and texel anchors at per-pixel
    integer mip ``level``; sizes/offsets are device int tensors."""
    lv = level.to(torch.int64)
    s = sizes[lv]
    off = offsets[lv]
    sf = s.to(torch.float32)
    x = u * sf - 0.5
    y = v * sf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = torch.where(x0 < 0, 0.0, x - x0)
    fy = torch.where(y0 < 0, 0.0, y - y0)
    x0i = torch.minimum(torch.clamp(x0.to(torch.int32), min=0), s - 1)
    y0i = torch.minimum(torch.clamp(y0.to(torch.int32), min=0), s - 1)
    return off + face * s * s + y0i * s + x0i, fx, fy, x0i, y0i


def mipcube_quad_index(sizes, offsets, level, face, u, v):
    """Quad-row index + bilinear fractions at per-pixel integer mip
    ``level`` (sampling.py:687)."""
    idx, fx, fy, _, _ = mipcube_quad_index_anchor(
        sizes, offsets, level, face, u, v
    )
    return idx, fx, fy


def _sample_mipcube_quad_level(rows, sizes, offsets, level, face, u, v):
    """RGBE bilinear sample at per-pixel integer mip ``level``: one row
    gather (sampling.py:696)."""
    idx, fx, fy = mipcube_quad_index(sizes, offsets, level, face, u, v)
    return quad_lerp_rgbe(take_rows(rows, idx), fx, fy)


def sample_mipcube_quad_lod(mq: MipCubeQuad, dirs, lod):
    """textureLod on the RGBE quad-packed chain: trilinear from two row
    gathers (sampling.py:728)."""
    sizes, offsets = _level_tables(mq, dirs.device)
    nl = mq.num_levels
    face, u, v = cube_face_uv(dirs)
    lod = torch.clamp(lod, 0.0, nl - 1)
    l0 = torch.floor(lod).to(torch.int32)
    l1 = torch.clamp(l0 + 1, max=nl - 1)
    f = (lod - l0.to(lod.dtype))[..., None]
    c0 = _sample_mipcube_quad_level(mq.rows, sizes, offsets, l0, face, u, v)
    c1 = _sample_mipcube_quad_level(mq.rows, sizes, offsets, l1, face, u, v)
    return c0 * (1 - f) + c1 * f


def _level_tables(mq, device):
    """A chain's level sizes and offsets as int32 tensors on ``device``,
    made once per chain and device and kept on the chain: a host-to-device
    copy per frame would stall the launch queue, and a CUDA graph cannot
    capture one."""
    tables = mq.__dict__.setdefault("_device_tables", {})
    device = torch.device(device)
    if device not in tables:
        tables[device] = (
            torch.as_tensor(mq.sizes, dtype=torch.int32, device=device),
            torch.as_tensor(mq.offsets, dtype=torch.int32, device=device),
        )
    return tables[device]


def sample_mipcube_quad_merged_lod(mq: MipCubeQuadMerged, dirs, lod):
    """textureLod on the merged child+parent layout: trilinear in ONE
    32-byte row gather; the parent fractions derive from the child
    anchor's parity (sampling.py:703)."""
    sizes, offsets = _level_tables(mq, dirs.device)
    nl = mq.num_levels
    face, u, v = cube_face_uv(dirs)
    lod = torch.clamp(lod, 0.0, nl - 1)
    l0 = torch.floor(lod).to(torch.int32)
    f = (lod - l0.to(lod.dtype))[..., None]
    idx, fx, fy, x0, y0 = mipcube_quad_index_anchor(
        sizes, offsets, l0, face, u, v
    )
    rows8 = take_rows(mq.rows, idx)
    c0 = quad_lerp_rgbe(rows8[..., :4], fx, fy)
    last = l0 >= nl - 1
    fpx = torch.where(last, fx, ((x0 & 1).to(fx.dtype) + fx) * 0.5)
    fpy = torch.where(last, fy, ((y0 & 1).to(fy.dtype) + fy) * 0.5)
    c1 = quad_lerp_rgbe(rows8[..., 4:], fpx, fpy)
    return c0 * (1 - f) + c1 * f


# --- equirectangular ------------------------------------------------------------

def spherical_uv(dirs):
    """Direction -> equirect uv (ibl/cubemap_brdflut.comp:155-160)."""
    u = torch.atan2(dirs[..., 2], dirs[..., 0]) / (2.0 * np.pi) + 0.5
    v = torch.asin(torch.clamp(dirs[..., 1], -1.0, 1.0)) / np.pi + 0.5
    return torch.stack([u, v], dim=-1)


def sample_equirect(tex, dirs):
    """Bilinear equirect sample by direction (wrap in x, clamp in y)."""
    uv = spherical_uv(dirs)
    h, w, c = tex.shape
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0.to(torch.int64) + 1, w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0.to(torch.int64) + 1, 0, h - 1)
    flat = tex.reshape(h * w, c)

    def tap(iy, ix):
        return flat[iy * w + ix]

    top = tap(y0i, x0i) * (1 - fx) + tap(y0i, x1i) * fx
    bot = tap(y1i, x0i) * (1 - fx) + tap(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy
