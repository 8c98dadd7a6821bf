"""Deferred shading + skybox (port of ``mo_renderer_tpu/passes/shading.py``):
the reference sampling path's ``shading_pass`` and the fast path's
``shading_pass_fast`` with the helpers each calls.

Per pixel: Cook-Torrance over the live lights, split-sum IBL ambient,
the 9-tap Poisson PCF shadow, ``color = (ambient + Lo*shadow) * ssao +
emissive``, Unreal tonemap, and the skybox where depth == 1.

- The reference path samples the maps directly: 9 bilinear taps on the
  raw shadow map, the irradiance cube, the trilinear specular mip chain,
  the BRDF LUT and the environment cube, all at full rate.
- The fast path takes SH9 irradiance, the polynomial BRDF, the RGBE
  quad-packed specular chain and a PCF window table evaluated on a
  strided grid and upsampled.  The specular taps follow the three
  ``spec_*`` flags: by default the mirror tap (which serves the sky) and
  the parent-mip tap both come from one merged child+parent row on the
  even grid; with flags off, either tap runs at full rate or from its
  own row.  The PCF table is whichever layout the config built
  (``pcf_u16`` / ``pcf_half_anchor``: u16 windows at every even texel by
  default, at every texel, or f32 2x4 wide rows); ``calculate_shadow_fast``
  reads the layout off the table.  With ``cb`` the G-buffer lives on the
  (H, W/2) checkerboard domain and only the upsample targets change; the
  full-rate mirror tap is not evaluated there and raises, as in the
  reference.

On a card each pass is one hand kernel: ``shading_pass`` K11
(``csrc/shading_ref.cu``), ``shading_pass_fast`` K9 (``csrc/shading.cu``);
their plain versions, ``_shading_ref_plain`` and ``_shading_fast_plain``,
are what the CPU runs.
"""

from __future__ import annotations

import torch

import ctypes

from ..device import sampling
from ..kernels import _build, brdf
from ..kernels.ibl import sh9_eval
from ..kernels.tonemap import tonemap_unreal

POISSON = [
    (-0.94201624, -0.39906216),
    (0.94558609, -0.76890725),
    (-0.094184101, -0.92938870),
    (0.34495938, 0.29387760),
    (-0.91588581, 0.45771432),
    (-0.81544232, -0.87912464),
    (-0.38277543, 0.27676845),
    (0.97484398, 0.75648379),
    (0.44323325, -0.97511554),
]
SHADOW_BIAS = 0.000005  # shading_pass.frag:67
SHADOW_INTENSITY = 0.25  # shading_pass.frag:82
MAX_REFLECTION_LOD = 7.0  # pbr.glsl:262


def calculate_shadow(world_pos, light_proj_view, shadow_map):
    """CalculateShadow (shading_pass.frag:56-84): 9 Poisson bilinear taps
    on the raw (S, S) shadow map.  Returns the (H, W) factor."""
    p = torch.cat([world_pos, torch.ones_like(world_pos[..., :1])], -1)
    lp = p @ light_proj_view.t()
    wc = torch.where(lp[..., 3].abs() > 1e-20, lp[..., 3], 1.0)
    proj = lp[..., :3] / wc[..., None]
    uv = proj[..., :2] * 0.5 + 0.5
    beyond_far = proj[..., 2] > 1.0
    current = proj[..., 2] - SHADOW_BIAS
    s = shadow_map.shape[0]
    texel = 1.0 / s
    sm = shadow_map[..., None]
    shadow = torch.zeros_like(current)
    for dx, dy in POISSON:
        tap_uv = torch.stack(
            [uv[..., 0] + dx * texel, uv[..., 1] + dy * texel], dim=-1
        )
        closest = sampling.sample_bilinear(
            sm, tap_uv, sampling.CLAMP_TO_EDGE
        )[..., 0]
        shadow = shadow + (current > closest).to(torch.float32)
    shadow = shadow / len(POISSON)
    result = (1.0 - shadow) * (1.0 - SHADOW_INTENSITY) + SHADOW_INTENSITY
    return torch.where(beyond_far, 1.0, result)


def ibl_ambient(gbuf, eye_pos, ibl):
    """imageBasedLighting (pbr.glsl:245-271) from the base maps: the
    irradiance cube, the trilinear specular chain and the BRDF LUT."""
    irradiance = sampling.sample_cubemap(
        ibl.irradiance_faces, gbuf.normal
    )[..., :3]
    r = brdf.ibl_reflection_dir(gbuf.position, gbuf.normal, eye_pos)
    lod = gbuf.orm[..., 1] * MAX_REFLECTION_LOD
    prefiltered = sampling.sample_mipcube_lod(
        ibl.specular_mips, r, lod
    )[..., :3]
    v = brdf.normalize(eye_pos - gbuf.position, eps=1e-20)
    ndotv = torch.clamp(brdf.dot3(gbuf.normal, v), min=0.0)
    lut_uv = torch.stack([ndotv, 1.0 - gbuf.orm[..., 1]], dim=-1)
    lut = sampling.sample_bilinear(
        ibl.brdf_lut, lut_uv, sampling.CLAMP_TO_EDGE
    )[..., :2]
    return brdf.image_based_lighting(
        gbuf.position, gbuf.base_color, gbuf.normal,
        gbuf.orm[..., 2], gbuf.orm[..., 1], gbuf.orm[..., 0],
        eye_pos, irradiance, prefiltered, lut,
    )


def skybox_color(height, width, camera_basis, env_faces):
    """Skybox ray reconstruction (skybox_fs, shading_pass.rs:367-399),
    sampled from the environment cube; (H, W, 3)."""
    return sampling.sample_cubemap(
        env_faces, _sky_dirs(height, width, camera_basis)
    )[..., :3]


def shading_pass(gbuf, ssao, shadow_map, lights, num_lights: int, params,
                 ibl=None):
    """The reference path's shading to tonemapped colour (H, W, 3) in
    [0, 1] (shading.py:149); ``ibl`` None: no ambient and no sky,
    ``shadow_map`` None: a shadow factor of 1.

    On a CUDA G-buffer this is the kernel of ``csrc/shading_ref.cu``
    (K11), for every option set; on the CPU it is the PyTorch ops of
    ``_shading_ref_plain``, the kernel's plain version."""
    args = (gbuf, ssao, shadow_map, lights, num_lights, params, ibl)
    if gbuf.depth.is_cuda:
        return _shading_ref_cuda(*args)
    return _shading_ref_plain(*args)


def _shading_ref_plain(gbuf, ssao, shadow_map, lights, num_lights, params,
                       ibl):
    """shading_pass in PyTorch ops: the CPU's path, and the plain version
    the kernel is held to on the card."""
    eye = params["eye_pos"]
    lo = shade_lights(gbuf, lights, num_lights, eye)
    ambient = (ibl_ambient(gbuf, eye, ibl) if ibl is not None
               else torch.zeros_like(lo))
    if shadow_map is not None:
        shadow = calculate_shadow(
            gbuf.position, params["light_proj_view"], shadow_map
        )
    else:
        shadow = torch.ones_like(ssao)
    color = (ambient + lo * shadow[..., None]) * ssao[..., None]
    color = tonemap_unreal(color + gbuf.emissive)
    if ibl is not None:
        # subpass 1: skybox only where depth == 1, not tonemapped
        sky = skybox_color(*gbuf.depth.shape, params, ibl.environment_faces)
        color = torch.where((gbuf.depth >= 1.0)[..., None], sky, color)
    return torch.clamp(color, 0.0, 1.0)


def shade_lights(gbuf, lights, num_lights: int, eye_pos):
    """Sum surfaceShading over the ``num_lights`` live light rows (the
    count is host-known, fixed at pack time)."""
    lo = torch.zeros_like(gbuf.base_color)
    for i in range(min(lights.shape[0], num_lights)):
        row = lights[i]
        lo = lo + brdf.surface_shading(
            gbuf.position, gbuf.base_color, gbuf.normal,
            gbuf.orm[..., 2], gbuf.orm[..., 1],
            row[0], row[4:7], row[8:11], row[12:15], row[16:20], eye_pos,
            spot_exponent=row[2],
        )
    return lo


def _select3(k, v0, v1, v2):
    return torch.where(k == 0, v0, torch.where(k == 1, v1, v2))


def pcf_window_anchor(world_pos, light_proj_view, s):
    """calculate_shadow_fast's light projection and the anchor of its 4x4
    texel window, clamped so the window stays on the map: (x0, y0 int32,
    the fractions ax, ay, the compare's ``current``, beyond_far)."""
    p = torch.cat([world_pos, torch.ones_like(world_pos[..., :1])], -1)
    lp = p @ light_proj_view.t()
    wc = torch.where(lp[..., 3].abs() > 1e-20, lp[..., 3], 1.0)
    proj = lp[..., :3] / wc[..., None]
    uv = proj[..., :2] * 0.5 + 0.5
    beyond_far = proj[..., 2] > 1.0
    current = proj[..., 2] - SHADOW_BIAS
    xf = torch.clamp(uv[..., 0] * s - 0.5, 1.0, s - 3.0)
    yf = torch.clamp(uv[..., 1] * s - 0.5, 1.0, s - 3.0)
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    return (x0.to(torch.int32), y0.to(torch.int32), xf - x0, yf - y0,
            current, beyond_far)


def calculate_shadow_fast(world_pos, light_proj_view, shadow_quad_rows, s):
    """PCF from the 4x4 texel window around the pixel's shadow texel, all
    9 Poisson taps arithmetic (shading.py:211).  The layout is read off
    the table (sampling.py's PCF builders): int32 rows are u16-packed
    windows, one row gather per pixel, anchored at every even texel when
    the table has (s/2)^2 rows, else at every texel; float32 rows are the
    2x4 wide rows, two gathers per pixel."""
    x0i, y0i, ax, ay, current, beyond_far = pcf_window_anchor(
        world_pos, light_proj_view, s)

    if shadow_quad_rows.dtype == torch.int32:
        xa = x0i - 1
        ya = y0i - 1
        half_anchor = shadow_quad_rows.shape[0] == (s // 2) ** 2
        if half_anchor:
            idx = (ya >> 1) * (s // 2) + (xa >> 1)
        else:
            idx = ya * s + xa
        q = sampling.take_rows(shadow_quad_rows, idx)

        def texel(r, c):
            v = (q[..., (r * 4 + c) // 2] >> (16 * (c & 1))) & 0xFFFF
            return v.to(torch.float32) * (1.0 / 65535.0)

        if half_anchor:
            ry = ya & 1
            rx = xa & 1
            phys = [[texel(r, c) for c in range(4)] for r in range(4)]

            def shifted(r, c):
                # logical texel (r, c) lives at physical (r+ry, c+rx);
                # neighbours past the window edge clamp to it
                r1, c1 = min(r + 1, 3), min(c + 1, 3)
                a = torch.where(rx == 0, phys[r][c], phys[r][c1])
                b = torch.where(rx == 0, phys[r1][c], phys[r1][c1])
                return torch.where(ry == 0, a, b)

            w_rows = [[shifted(r, c) for c in range(4)] for r in range(4)]
        else:
            w_rows = [[texel(r, c) for c in range(4)] for r in range(4)]
    else:
        def wide(dy):  # rows (y0+dy, y0+dy+1) x cols (x0-1 .. x0+2)
            return sampling.take_rows(
                shadow_quad_rows, (y0i + dy) * s + (x0i - 1)
            )

        g_top = wide(-1)
        g_bot = wide(1)
        w_rows = [
            [g_top[..., c] for c in range(4)],
            [g_top[..., 4 + c] for c in range(4)],
            [g_bot[..., c] for c in range(4)],
            [g_bot[..., 4 + c] for c in range(4)],
        ]

    shadow = torch.zeros_like(current)
    for dx, dy in POISSON:
        sx = ax + dx
        sy = ay + dy
        kx = torch.floor(sx)
        ky = torch.floor(sy)
        fx = sx - kx
        fy = sy - ky
        cx = kx.to(torch.int32) + 1
        cy = ky.to(torch.int32) + 1

        def col(r):
            left = _select3(cx, w_rows[r][0], w_rows[r][1], w_rows[r][2])
            right = _select3(cx, w_rows[r][1], w_rows[r][2], w_rows[r][3])
            return left * (1 - fx) + right * fx

        rows = [col(r) for r in range(4)]
        top = _select3(cy, rows[0], rows[1], rows[2])
        bot = _select3(cy, rows[1], rows[2], rows[3])
        closest = top * (1 - fy) + bot * fy
        shadow = shadow + (current > closest).to(torch.float32)

    shadow = shadow / len(POISSON)
    result = (1.0 - shadow) * (1.0 - SHADOW_INTENSITY) + SHADOW_INTENSITY
    return torch.where(beyond_far, 1.0, result)


def _even_grid(a, strides=(2, 2)):
    """a[::sy, ::sx] over the first two axes."""
    return a[:: strides[0], :: strides[1]]


def _upsample_pow2(a, h, w, f, fx=None):
    """Bilinear upsample aligned with ``x[::f, ::fx]`` sampling: output
    (f*i, fx*j) are exact samples, in-between positions interpolate the
    two neighbours per axis.  (Hs, Ws) or (Hs, Ws, C)."""
    fx = f if fx is None else fx

    def up_axis(v, axis, fk):
        if fk == 1:
            return v
        n = v.shape[axis]
        nxt = torch.cat(
            [v.narrow(axis, 1, n - 1), v.narrow(axis, n - 1, 1)], dim=axis
        )
        phases = [v * (1.0 - k / fk) + nxt * (k / fk) for k in range(fk)]
        st = torch.stack(phases, dim=axis + 1)
        shape = list(v.shape)
        shape[axis] *= fk
        return st.reshape(shape)

    return up_axis(up_axis(a, 0, f), 1, fx)[:h, :w]


def _upsample2x(a, h, w):
    return _upsample_pow2(a, h, w, 2)


def _cb_row_odd(h, ndim, device):
    odd = (torch.arange(h, device=device) & 1).to(torch.bool)
    return odd.reshape((h,) + (1,) * (ndim - 1))


def _upsample_to_cb(a, h, wc, fy, fxc):
    """Samples at full (fy*i, 2*fxc*j) -> cb-domain (h, wc) values."""
    g = _upsample_pow2(a, h, wc, fy, fxc)  # values at full (y, 2j)
    gr = torch.cat([g[:, 1:], g[:, -1:]], dim=1)
    odd = _cb_row_odd(h, a.ndim, a.device)
    return torch.where(odd, 0.5 * (g + gr), g)


def _mask_aware(up, vals_h, mask_h, mask_t, nn):
    """Where the four contributing samples straddle a mask boundary, use
    the nearest sample whose mask matches the target pixel's."""
    mask_f = mask_h.to(torch.float32)
    phases = [(0, 0), (0, 1), (1, 0), (1, 1)]
    ms = [nn(mask_f, dy, dx) > 0.5 for dy, dx in phases]
    uniform = (ms[0] == ms[1]) & (ms[0] == ms[2]) & (ms[0] == ms[3])
    res = up
    done = torch.zeros_like(mask_t)
    for (dy, dx), m in zip(phases, ms):
        use = (~uniform) & (~done) & (m == mask_t)
        res = torch.where(use[..., None], nn(vals_h, dy, dx), res)
        done = done | use
    return res


def _shift(a, dy, dx):
    if dy:
        a = torch.cat([a[dy:], a[-1:]], dim=0)
    if dx:
        a = torch.cat([a[:, dx:], a[:, -1:]], dim=1)
    return a


def _upsample_to_cb_mask_aware(vals_h, mask_h, mask_cb, h, wc):
    """_upsample_to_cb for the (2, 1) grid without blending across a
    mask boundary (shading.py:384)."""
    def nn(a, dy, dx):  # cb pixel (y, j) reads a[y//2 + dy, j + dx]
        return _shift(a, dy, dx).repeat_interleave(2, dim=0)[:h, :wc]

    return _mask_aware(_upsample_to_cb(vals_h, h, wc, 2, 1), vals_h, mask_h,
                       mask_cb, nn)


def _upsample2x_mask_aware(vals_h, mask_h, mask_full, h, w):
    """Bilinear 2x upsample without blending across a mask boundary."""
    def nn(a, dy, dx):  # full pixel (y, x) reads a[y//2 + dy, x//2 + dx]
        r = _shift(a, dy, dx).repeat_interleave(2, dim=0)
        return r.repeat_interleave(2, dim=1)[:h, :w]

    return _mask_aware(_upsample_pow2(vals_h, h, w, 2), vals_h, mask_h,
                       mask_full, nn)


def half_res_geometry(gbuf, cb=False):
    """Even-grid (position, normal, roughness, depth) planes; on the cb
    domain the full frame's even grid is a (2, 1) stride."""
    st = (2, 1) if cb else (2, 2)
    return (
        _even_grid(gbuf.position, st),
        _even_grid(gbuf.normal, st),
        _even_grid(gbuf.orm[..., 1], st),
        _even_grid(gbuf.depth, st),
    )


def calculate_shadow_fast_half(pos_half, full_hw, light_proj_view,
                               shadow_quad_rows, s, divisor=2, cb=False):
    """PCF on the strided grid (divisor 2 or 4), bilinearly upsampled to
    the shading domain."""
    h, w = full_hw
    if divisor == 4:
        pos_half = _even_grid(pos_half)
    factor = calculate_shadow_fast(pos_half, light_proj_view,
                                   shadow_quad_rows, s)
    if cb:
        return _upsample_to_cb(factor, h, w, divisor, divisor // 2)
    return _upsample_pow2(factor, h, w, divisor)


def _sky_dirs(height, width, camera_basis, stride: int = 1,
              row_offset: int = 0, full_height: int | None = None):
    """Per-pixel skybox ray directions (skybox_fs near-plane basis) at
    pixels (stride*i, stride*j) of the height x width frame; a band of a
    row-sharded frame gives its first row and the frame's height."""
    dev = camera_basis["right"].device
    fh = height if full_height is None else full_height
    v = torch.arange(height // stride, dtype=torch.float32,
                     device=dev) * stride
    if row_offset:  # a band; the whole frame launches no add of 0
        v = v + row_offset
    v = (v + 0.5) / fh
    u = (torch.arange(width // stride, dtype=torch.float32, device=dev)
         * stride + 0.5) / width
    y = (v * 2.0 - 1.0)[:, None, None]
    x = (u * 2.0 - 1.0)[None, :, None]
    near_wh = camera_basis["near_wh"]
    d = (
        x * (near_wh[0] / 2.0) * camera_basis["right"]
        + y * (near_wh[1] / 2.0) * camera_basis["up"]
        - camera_basis["near"] * camera_basis["direction"]
    )
    return d * torch.reciprocal(
        torch.sqrt(torch.clamp((d * d).sum(-1, keepdim=True), min=1e-20))
    )


def _env_quad_index(ibl, dirs):
    """Quad-row index + fractions for the environment sample, served
    from the specular table's mip-0 region (mip 0 IS the environment)."""
    s = int(ibl.specular_quad.sizes[0])
    env_off = int(ibl.specular_quad.offsets[0])
    face, u, v = sampling.cube_face_uv(dirs)
    idx, fx, fy = sampling.bilinear_weights(
        torch.stack([u, v], dim=-1), s, s, sampling.CLAMP_TO_EDGE
    )
    return env_off + face * (s * s) + idx, fx, fy


def skybox_color_fast(height, width, camera_basis, ibl):
    """Skybox from the quad-packed environment rows, one row gather per
    pixel (shading.py:547); the frame gets its sky inside
    ``ibl_ambient_sky_fast``, so this is for standalone use."""
    d = _sky_dirs(height, width, camera_basis)
    idx, fx, fy = _env_quad_index(ibl, d)
    return sampling.quad_lerp_rgbe(
        sampling.take_rows(ibl.specular_quad.rows, idx), fx, fy)


def ibl_ambient_fast(gbuf, eye_pos, ibl):
    """Split-sum ambient from SH9 irradiance, the RGBE quad-packed
    specular chain (two row gathers) and the polynomial BRDF
    (shading.py:490)."""
    irradiance = sh9_eval(ibl.irradiance_sh9, gbuf.normal)
    r = brdf.ibl_reflection_dir(gbuf.position, gbuf.normal, eye_pos)
    lod = gbuf.orm[..., 1] * MAX_REFLECTION_LOD
    prefiltered = sampling.sample_mipcube_quad_lod(ibl.specular_quad, r, lod)
    return _ambient(gbuf, eye_pos, irradiance, prefiltered)


def _ambient(gbuf, eye_pos, irradiance, prefiltered):
    veye = brdf.normalize(eye_pos - gbuf.position, eps=1e-20)
    ndotv = torch.clamp(brdf.dot3(gbuf.normal, veye), min=0.0)
    lut = brdf.env_brdf_poly(ndotv, gbuf.orm[..., 1])
    return brdf.image_based_lighting(
        gbuf.position, gbuf.base_color, gbuf.normal,
        gbuf.orm[..., 2], gbuf.orm[..., 1], gbuf.orm[..., 0],
        eye_pos, irradiance, prefiltered, lut,
    )


def ibl_ambient_sky_fast(gbuf, eye_pos, ibl, camera_basis,
                         parent_mip_half_res=True, half_geo=None,
                         mirror_half_res=True, merged_trilinear=True,
                         cb=False, row_offset=0, full_height=None):
    """Ambient AND sky from the trilinear specular taps (shading.py:558):
    sky pixels (depth == 1) re-point the mirror tap at the environment,
    which is mip 0 of the specular table.  Returns (ambient (H,W,3), sky
    (H,W,3), sky_mask (H,W) bool).

    - ``mirror_half_res``: the mirror tap and the sky on the even grid,
      upsampled without blending across the sky silhouette; off, at full
      rate (not on the checkerboard domain, where it raises as the
      reference does).
    - ``parent_mip_half_res``: the coarser tap (mip l0+1) on the even
      grid, upsampled; off, at full rate.
    - ``merged_trilinear`` (needs both): both taps from one row of the
      child+parent table, the parent's fractions from the child anchor's
      parity.

    ``row_offset`` / ``full_height``: the band's first row and the frame's
    height, for the sky rays of a row-sharded frame."""
    nl = ibl.specular_quad.num_levels
    lod = torch.clamp(gbuf.orm[..., 1] * MAX_REFLECTION_LOD, 0.0, nl - 1)
    l0 = torch.floor(lod).to(torch.int32)
    f = (lod - l0.to(lod.dtype))[..., None]
    sky_mask = gbuf.depth >= 1.0
    h, w = gbuf.depth.shape
    # on the checkerboard domain w is the half width; sky rays take x
    # against the full frame width
    sky_w = 2 * w if cb else w
    if cb and not mirror_half_res:
        raise NotImplementedError(
            "checkerboard shading requires spec_mirror_half_res (full-res "
            "sky rays are not evaluated on the cb domain)"
        )
    if (mirror_half_res or parent_mip_half_res) and half_geo is None:
        half_geo = half_res_geometry(gbuf, cb=cb)

    def upsample(vals_h):
        return (_upsample_to_cb(vals_h, h, w, 2, 1) if cb
                else _upsample2x(vals_h, h, w))

    c1 = None
    if mirror_half_res:
        c0h, c1h, sky_h, _ = even_grid_taps(
            half_geo, eye_pos, ibl, camera_basis, h, sky_w,
            merged_trilinear and parent_mip_half_res, row_offset,
            full_height)
        if c1h is not None:
            c1 = upsample(c1h)
        if cb:
            c0 = _upsample_to_cb_mask_aware(c0h, sky_h, sky_mask, h, w)
        else:
            c0 = _upsample2x_mask_aware(c0h, sky_h, sky_mask, h, w)
    else:
        c0 = mirror_tap_full(gbuf, eye_pos, ibl, camera_basis, row_offset,
                             full_height)[0]

    if c1 is None and parent_mip_half_res:
        c1 = upsample(parent_tap(*half_geo[:3], eye_pos, ibl)[0])
    elif c1 is None:
        c1 = parent_tap(gbuf.position, gbuf.normal, gbuf.orm[..., 1],
                        eye_pos, ibl)[0]

    prefiltered = c0 * (1 - f) + c1 * f  # garbage at sky pixels (masked)
    irradiance = sh9_eval(ibl.irradiance_sh9, gbuf.normal)
    return _ambient(gbuf, eye_pos, irradiance, prefiltered), c0, sky_mask


def even_grid_taps(half_geo, eye_pos, ibl, camera_basis, height, sky_w,
                   merged, row_offset=0, full_height=None):
    """The mirror tap on the even grid (``half_res_geometry``'s planes),
    the sky samples re-pointed at the environment: (c0h, the merged
    parent tap c1h or None, the sky flags, the table rows the mirror tap
    reads).  ``merged``: both taps from one row of the child+parent
    table, the parent's fractions from the child anchor's parity."""
    mq = ibl.specular_quad
    nl = mq.num_levels
    pos_h, n_h, rough_h, depth_h = half_geo
    sizes, offsets = sampling._level_tables(mq, depth_h.device)
    rh = brdf.ibl_reflection_dir(pos_h, n_h, eye_pos)
    l0h = torch.floor(
        torch.clamp(rough_h * MAX_REFLECTION_LOD, 0.0, nl - 1)
    ).to(torch.int32)
    fh, uh, vh = sampling.cube_face_uv(rh)
    idx0, fx0, fy0, x0i, y0i = sampling.mipcube_quad_index_anchor(
        sizes, offsets, l0h, fh, uh, vh
    )
    sky_h = depth_h >= 1.0
    eidx, efx, efy = _env_quad_index(
        ibl, _sky_dirs(height, sky_w, camera_basis, stride=2,
                       row_offset=row_offset, full_height=full_height)
    )
    idx0 = torch.where(sky_h, eidx, idx0)
    fx0 = torch.where(sky_h, efx, fx0)
    fy0 = torch.where(sky_h, efy, fy0)
    if not merged:
        return (sampling.quad_lerp_rgbe(sampling.take_rows(mq.rows, idx0),
                                        fx0, fy0), None, sky_h, idx0)
    # one 32-byte row: child quad + parent quad (the sky pixels' parent
    # lanes are garbage, masked out through f)
    rows8 = sampling.take_rows(ibl.specular_quad_merged.rows, idx0)
    c0h = sampling.quad_lerp_rgbe(rows8[..., :4], fx0, fy0)
    last = l0h >= nl - 1
    fpx = torch.where(last, fx0, ((x0i & 1).to(fx0.dtype) + fx0) * 0.5)
    fpy = torch.where(last, fy0, ((y0i & 1).to(fy0.dtype) + fy0) * 0.5)
    return (c0h, sampling.quad_lerp_rgbe(rows8[..., 4:], fpx, fpy), sky_h,
            idx0)


def spec_tap_index(pos, n, rough, eye_pos, ibl, parent):
    """The row index and fractions of the specular tap along the
    reflection at (pos, n): mip l0 = floor(clamp(roughness * 7)), or with
    ``parent`` its parent l0 + 1."""
    mq = ibl.specular_quad
    nl = mq.num_levels
    sizes, offsets = sampling._level_tables(mq, pos.device)
    lvl = torch.floor(torch.clamp(rough * MAX_REFLECTION_LOD, 0.0, nl - 1)
                      ).to(torch.int32)
    if parent:
        lvl = torch.clamp(lvl + 1, max=nl - 1)
    face, u, v = sampling.cube_face_uv(
        brdf.ibl_reflection_dir(pos, n, eye_pos))
    return sampling.mipcube_quad_index(sizes, offsets, lvl, face, u, v)


def mirror_tap_full(gbuf, eye_pos, ibl, camera_basis, row_offset=0,
                    full_height=None):
    """The mirror tap at full rate, sky pixels (depth >= 1) re-pointed at
    the environment: (c0, the table rows it reads)."""
    h, w = gbuf.depth.shape
    sky = gbuf.depth >= 1.0
    idx0, fx0, fy0 = spec_tap_index(gbuf.position, gbuf.normal,
                                    gbuf.orm[..., 1], eye_pos, ibl, False)
    eidx, efx, efy = _env_quad_index(
        ibl, _sky_dirs(h, w, camera_basis, row_offset=row_offset,
                       full_height=full_height))
    idx0 = torch.where(sky, eidx, idx0)
    fx0 = torch.where(sky, efx, fx0)
    fy0 = torch.where(sky, efy, fy0)
    return (sampling.quad_lerp_rgbe(
        sampling.take_rows(ibl.specular_quad.rows, idx0), fx0, fy0), idx0)


def parent_tap(pos, n, rough, eye_pos, ibl):
    """The parent-mip tap (mip l0 + 1) from its own row, on the even grid
    (``half_res_geometry``'s planes) or at full rate: (c1, the table rows
    it reads)."""
    idx1, fx1, fy1 = spec_tap_index(pos, n, rough, eye_pos, ibl, True)
    return (sampling.quad_lerp_rgbe(
        sampling.take_rows(ibl.specular_quad.rows, idx1), fx1, fy1), idx1)


def shading_pass_fast(gbuf, ssao, shadow_quad_rows, shadow_size, lights,
                      num_lights: int, params, ibl=None,
                      shadow_res_divisor=1, parent_mip_half_res=True,
                      mirror_half_res=True, merged_trilinear=True, cb=False,
                      row_offset=0, full_height=None):
    """Tonemapped colour (H, W, 3) in [0, 1] on the G-buffer's domain
    (shading.py:717); the three ``spec_*`` flags choose the specular
    branches of ``ibl_ambient_sky_fast``.  A band of a row-sharded frame
    passes its first row (even, so that its row parity is the frame's
    checkerboard phase) and the frame's height.

    On a CUDA G-buffer this is the kernel of ``csrc/shading.cu``
    (K9), for every option set; on the CPU it is the PyTorch ops of
    ``_shading_fast_plain``, the kernel's plain version."""
    args = (gbuf, ssao, shadow_quad_rows, shadow_size, lights, num_lights,
            params, ibl, shadow_res_divisor, parent_mip_half_res,
            mirror_half_res, merged_trilinear, cb, row_offset, full_height)
    if gbuf.depth.is_cuda:
        return _shading_fast_cuda(*args)
    return _shading_fast_plain(*args)


def _shading_fast_plain(gbuf, ssao, shadow_quad_rows, shadow_size, lights,
                        num_lights, params, ibl, shadow_res_divisor,
                        parent_mip_half_res, mirror_half_res,
                        merged_trilinear, cb, row_offset, full_height):
    """shading_pass_fast in PyTorch ops: the CPU's path, and the plain
    version the kernel is held to on the card."""
    eye = params["eye_pos"]
    lo = shade_lights(gbuf, lights, num_lights, eye)
    # one shared even-grid slice feeds every half-res consumer
    need_half = (
        shadow_res_divisor > 1 and shadow_quad_rows is not None
    ) or (ibl is not None and (parent_mip_half_res or mirror_half_res))
    half_geo = half_res_geometry(gbuf, cb=cb) if need_half else None

    if ibl is not None:
        ambient, sky, sky_mask = ibl_ambient_sky_fast(
            gbuf, eye, ibl, params, parent_mip_half_res=parent_mip_half_res,
            half_geo=half_geo, mirror_half_res=mirror_half_res,
            merged_trilinear=merged_trilinear, cb=cb, row_offset=row_offset,
            full_height=full_height,
        )
    else:
        ambient = torch.zeros_like(lo)

    if shadow_quad_rows is not None:
        if shadow_res_divisor > 1:
            shadow = calculate_shadow_fast_half(
                half_geo[0], gbuf.depth.shape, params["light_proj_view"],
                shadow_quad_rows, shadow_size, divisor=shadow_res_divisor,
                cb=cb,
            )
        else:
            shadow = calculate_shadow_fast(
                gbuf.position, params["light_proj_view"], shadow_quad_rows,
                shadow_size,
            )
    else:
        shadow = torch.ones_like(ssao)

    color = (ambient + lo * shadow[..., None]) * ssao[..., None]
    color = tonemap_unreal(color + gbuf.emissive)
    if ibl is not None:
        # skybox where depth == 1, not tonemapped (skybox_fs)
        color = torch.where(sky_mask[..., None], sky, color)
    return torch.clamp(color, 0.0, 1.0)


# --- K9: the kernel of csrc/shading.cu ---------------------------------------

# the PCF table layouts, read off the table as calculate_shadow_fast reads
# them (csrc/shading.cu kPcf*)
PCF_NONE, PCF_U16_HALF, PCF_U16_FULL, PCF_F32_WIDE = 0, 1, 2, 3
PCF_DIVISORS = (1, 2, 4)
# what csrc/shading.cu and csrc/shading_ref.cu keep in shared memory: the
# light rows' columns they read (kLightCols), the rows of the chunk a light
# table of any length streams through (kLightChunkRows), the specular levels
LIGHT_COLS = 19
LIGHT_CHUNK_ROWS = 538
MAX_LEVELS = 16
# the debug output's int32 channels per pixel of the shading domain
# (csrc/shading.cu kDbg*), each a discrete choice the kernel makes at full
# rate, -1 where it makes none: the table rows of the full-rate mirror tap
# (at a sky pixel the environment's) and parent tap, the even-grid sample
# the mask-aware upsample of the mirror tap takes (i * wh + j; -1 where it
# blends the four), and the PCF window's anchor at divisor 1 (y << 16 | x)
FAST_DEBUG = ("mirror_row", "parent_row", "mirror_pick", "pcf_anchor")


def pcf_layout(shadow_quad_rows, s: int) -> int:
    """The layout code of a PCF table for an ``s`` x ``s`` shadow map
    (sampling.py's builders): u16 windows at every even texel or at every
    texel, or f32 2x4 wide rows; raises on a table of no layout."""
    if shadow_quad_rows is None:
        return PCF_NONE
    n, width = shadow_quad_rows.shape
    if shadow_quad_rows.dtype == torch.int32:
        code = PCF_U16_HALF if n == (s // 2) ** 2 else PCF_U16_FULL
    elif shadow_quad_rows.dtype == torch.float32:
        code = PCF_F32_WIDE
    else:
        code = None
    if code is None or width != 8 or (code != PCF_U16_HALF and n != s * s):
        raise ValueError(
            f"shading: a PCF table of {tuple(shadow_quad_rows.shape)} "
            f"{shadow_quad_rows.dtype} rows fits no layout of a {s}^2 map"
        )
    return code


class ShadeArgs(ctypes.Structure):
    """csrc/shading.cu's ShadeArgs, field for field."""

    _fields_ = [
        ("planes", ctypes.c_void_p * 5),
        ("strides", ctypes.c_longlong * 15),
        ("depth", ctypes.c_void_p),
        ("depth_strides", ctypes.c_longlong * 2),
        ("ssao", ctypes.c_void_p),
        ("ssao_strides", ctypes.c_longlong * 2),
        *[(name, ctypes.c_void_p) for name in (
            "out", "c0h", "c1h", "skyh", "pcf", "rows_h", "lights", "eye",
            "light_pv",
            "right", "up", "direction", "near", "near_wh", "sh9",
            "spec_rows", "merged_rows", "sizes", "offsets", "pcf_rows")],
        *[(name, ctypes.c_int) for name in (
            "h", "w", "hh", "wh", "hq", "wq", "cb", "has_ibl",
            "mirror_half", "parent_half", "merged", "num_levels", "env_size",
            "env_off", "pcf_layout", "shadow_size", "pcf_div", "row_offset",
            "full_height", "sky_w", "light_stride", "n_lights")],
        ("dbg", ctypes.c_void_p),
    ]


GBUFFER_PLANES = ("position", "normal", "base_color", "emissive", "orm")


def _ptr(t):
    return None if t is None else t.data_ptr()


def shade_args(gbuf, ssao, shadow_quad_rows, shadow_size, lights,
               num_lights, params, ibl, shadow_res_divisor,
               parent_mip_half_res, mirror_half_res, merged_trilinear, cb,
               row_offset, full_height, debug=False):
    """What the kernel reads: (ShadeArgs, the tensors it writes and keeps
    alive -- ``out`` and, with ``debug``, the even-grid samples the kernel
    keeps in shared memory: the mirror/sky tap ``c0h``, the parent tap
    ``c1h``, the sky flags ``skyh``, the table rows the two taps read
    ``rows_h``, and the PCF factor ``pcf`` on the divisor's grid (the whole
    domain at divisor 1), each where the options evaluate it; and ``dbg``,
    each pixel's FAST_DEBUG choices).  Pure Python over the tensors' pointers,
    shapes and strides: nothing is read from the device, and the outputs
    come from the caching allocator, so a CUDA graph captures the call."""
    dev = gbuf.depth.device
    h, w = gbuf.depth.shape
    if shadow_res_divisor not in PCF_DIVISORS:
        raise ValueError(f"shading: shadow_res_divisor {shadow_res_divisor} "
                         f"is not one of {PCF_DIVISORS}")
    if ibl is not None and cb and not mirror_half_res:
        raise NotImplementedError(
            "checkerboard shading requires spec_mirror_half_res (full-res "
            "sky rays are not evaluated on the cb domain)"
        )
    planes = [getattr(gbuf, k) for k in GBUFFER_PLANES]
    for k, t in zip(GBUFFER_PLANES, planes):
        if tuple(t.shape) != (h, w, 3):
            raise ValueError(f"shading: gbuf.{k} is {tuple(t.shape)}, "
                             f"expected {(h, w, 3)}")
    if tuple(ssao.shape) != (h, w):
        raise ValueError(f"shading: ssao is {tuple(ssao.shape)}, expected "
                         f"{(h, w)}")
    if lights.shape[1] < LIGHT_COLS:
        raise ValueError(f"shading: light rows of {lights.shape[1]} "
                         f"columns, the kernel reads {LIGHT_COLS}")
    layout = pcf_layout(shadow_quad_rows, shadow_size)
    has_ibl = ibl is not None
    mirror = has_ibl and mirror_half_res
    parent = has_ibl and parent_mip_half_res
    hh, wh = (h + 1) // 2, w if cb else (w + 1) // 2
    hq, wq = {1: (h, w), 2: (hh, wh),
              4: ((hh + 1) // 2, (wh + 1) // 2)}[shadow_res_divisor]

    def empty(shape, dtype=torch.float32, want=True):
        return torch.empty(shape, dtype=dtype, device=dev) \
            if want and debug else None

    keep = {
        "out": torch.empty((h, w, 3), dtype=torch.float32, device=dev),
        "c0h": empty((hh, wh, 3), want=mirror),
        "c1h": empty((hh, wh, 3), want=parent),
        "skyh": empty((hh, wh), torch.uint8, want=mirror),
        "rows_h": empty((hh, wh, 2), torch.int32, want=mirror or parent),
        "pcf": empty((hq, wq), want=layout != PCF_NONE),
        "dbg": empty((h, w, len(FAST_DEBUG)), torch.int32),
    }
    if lights.stride(-1) != 1:
        lights = lights.contiguous()
    small = {k: params[k].contiguous() for k in (
        "eye_pos", "light_proj_view", "right", "up", "direction", "near",
        "near_wh")}
    keep.update(lights=lights, **small)
    a = ShadeArgs()
    a.planes[:] = [t.data_ptr() for t in planes]
    a.strides[:] = [st for t in planes for st in t.stride()]
    a.depth, a.depth_strides[:] = gbuf.depth.data_ptr(), gbuf.depth.stride()
    a.ssao, a.ssao_strides[:] = ssao.data_ptr(), ssao.stride()
    for k in ("out", "c0h", "c1h", "skyh", "rows_h", "pcf", "dbg",
              "lights"):
        setattr(a, k, _ptr(keep[k]))
    a.eye, a.light_pv = _ptr(small["eye_pos"]), _ptr(small["light_proj_view"])
    a.right, a.up = _ptr(small["right"]), _ptr(small["up"])
    a.direction, a.near = _ptr(small["direction"]), _ptr(small["near"])
    a.near_wh = _ptr(small["near_wh"])
    a.h, a.w, a.hh, a.wh, a.hq, a.wq = h, w, hh, wh, hq, wq
    a.cb, a.has_ibl, a.mirror_half, a.parent_half = cb, has_ibl, mirror, \
        parent
    a.merged = mirror and parent and merged_trilinear
    if has_ibl:
        mq = ibl.specular_quad
        sizes, offsets = sampling._level_tables(mq, dev)
        keep.update(sh9=ibl.irradiance_sh9.contiguous(), sizes=sizes,
                    offsets=offsets)
        a.sh9, a.sizes, a.offsets = (_ptr(keep["sh9"]), _ptr(sizes),
                                     _ptr(offsets))
        a.spec_rows = _ptr(mq.rows)
        if a.merged:
            a.merged_rows = _ptr(ibl.specular_quad_merged.rows)
        a.num_levels = mq.num_levels
        a.env_size, a.env_off = int(mq.sizes[0]), int(mq.offsets[0])
    a.pcf_layout, a.shadow_size = layout, shadow_size
    a.pcf_div = shadow_res_divisor
    a.pcf_rows = _ptr(shadow_quad_rows)
    a.row_offset = row_offset
    a.full_height = h if full_height is None else full_height
    a.sky_w = 2 * w if cb else w
    a.light_stride = lights.stride(0)
    a.n_lights = min(lights.shape[0], num_lights)
    if has_ibl and a.num_levels > MAX_LEVELS:
        raise ValueError(f"shading: {a.num_levels} specular levels, the "
                         f"kernel takes {MAX_LEVELS}")
    return a, keep


def _shading_fast_cuda(*args, debug=False):
    """K9: one launch on the current stream.  ``debug``: also write the
    even-grid samples and each pixel's full-rate choices (shade_args) and
    return (colour, the kept tensors)."""
    gbuf, ssao, rows, _, lights, _, params, ibl = args[:8]
    tensors = [getattr(gbuf, k) for k in GBUFFER_PLANES] + [
        gbuf.depth, ssao, lights, params["eye_pos"]] + (
        [ibl.irradiance_sh9] if ibl is not None else [])
    dev = gbuf.depth.device
    for i, t in enumerate(tensors):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"shading: argument {i} is {t.dtype} on "
                             f"{t.device}, expected float32 on {dev}")
    if ibl is not None:
        _build.require_cuda(
            "shading", ibl.specular_quad.rows, ibl.specular_quad_merged.rows,
            dtypes=(torch.int32, torch.int32))
    if rows is not None:
        _build.require_cuda("shading", rows)
    a, keep = shade_args(*args, debug=debug)
    launch_shading(a, keep["out"])
    return (keep["out"], keep) if debug else keep["out"]


def launch_shading(a, like):
    """The C entry of csrc/shading.cu on ``like``'s stream; one count."""
    lib = _build.library()
    if lib.mo_shading_args_size() != ctypes.sizeof(ShadeArgs):
        raise RuntimeError("shading: ShadeArgs does not match csrc/shading.cu")
    fn = _build.function("mo_shading", [ctypes.POINTER(ShadeArgs), _build.P])
    _build.check("shading", fn(ctypes.byref(a), _build.stream_of(like)))
    _build.count("shading")


# --- K11: the kernel of csrc/shading_ref.cu -----------------------------------

# the debug output's int32 channels per pixel (csrc/shading_ref.cu kDbg*):
# the PCF compare bits and beyond_far, the 9 tap anchors, the packed cube
# faces, the lower mip level, the anchors of the irradiance, specular l0
# and l1, BRDF LUT and environment samples; -1 where not evaluated
REF_DEBUG = ("pcf", *[f"tap{t}" for t in range(9)], "faces", "level",
             "irradiance", "spec0", "spec1", "lut", "env")


class ShadeRefArgs(ctypes.Structure):
    """csrc/shading_ref.cu's ShadeRefArgs, field for field."""

    _fields_ = [
        ("planes", ctypes.c_void_p * 5),
        ("strides", ctypes.c_int * 15),
        ("depth", ctypes.c_void_p),
        ("depth_strides", ctypes.c_int * 2),
        ("ssao", ctypes.c_void_p),
        ("ssao_strides", ctypes.c_int * 2),
        *[(name, ctypes.c_void_p) for name in (
            "out", "dbg", "lights", "eye", "light_pv", "right", "up",
            "direction", "near", "near_wh", "shadow", "irr", "env", "spec",
            "lut")],
        ("tap_off", ctypes.c_float * 18),
        ("sizes", ctypes.c_int * MAX_LEVELS),
        ("offsets", ctypes.c_int * MAX_LEVELS),
        *[(name, ctypes.c_int) for name in (
            "h", "w", "shadow_size", "has_ibl", "irr_size", "irr_c",
            "env_size", "env_c", "spec_c", "num_levels", "lut_h", "lut_w",
            "lut_c", "light_stride", "n_lights")],
    ]


def _int32_extent(name, t):
    """Raise unless every element of ``t`` lies within 32-bit offsets of
    its first, as the kernel indexes it."""
    if _build.max_offset(t) > _build.INT32_MAX:
        raise ValueError(f"shading: {name} spans past the kernel's 32-bit "
                         "offsets")


def shade_ref_args(gbuf, ssao, shadow_map, lights, num_lights, params, ibl,
                   debug=False):
    """What K11 reads: (ShadeRefArgs, the tensors it writes and keeps
    alive -- ``out`` and, with ``debug``, ``dbg``: each pixel's REF_DEBUG
    channels).  Pure Python over the tensors' pointers, shapes and
    strides: nothing is read from the device, and the outputs come from
    the caching allocator, so a CUDA graph captures the call."""
    dev = gbuf.depth.device
    h, w = gbuf.depth.shape
    planes = [getattr(gbuf, k) for k in GBUFFER_PLANES]
    for k, t in zip(GBUFFER_PLANES, planes):
        if tuple(t.shape) != (h, w, 3):
            raise ValueError(f"shading: gbuf.{k} is {tuple(t.shape)}, "
                             f"expected {(h, w, 3)}")
    if tuple(ssao.shape) != (h, w):
        raise ValueError(f"shading: ssao is {tuple(ssao.shape)}, expected "
                         f"{(h, w)}")
    if lights.shape[1] < LIGHT_COLS:
        raise ValueError(f"shading: light rows of {lights.shape[1]} "
                         f"columns, the kernel reads {LIGHT_COLS}")
    n_lights = min(lights.shape[0], num_lights)
    for name, t in [*zip(GBUFFER_PLANES, planes), ("depth", gbuf.depth),
                    ("ssao", ssao)]:
        _int32_extent(name, t)
    if h * w * len(REF_DEBUG) > _build.INT32_MAX:
        raise ValueError(f"shading: a {h} x {w} frame is past the kernel's "
                         "32-bit offsets")
    keep = {"out": torch.empty((h, w, 3), dtype=torch.float32, device=dev)}
    if debug:
        keep["dbg"] = torch.empty((h, w, len(REF_DEBUG)), dtype=torch.int32,
                                  device=dev)
    if lights.stride(-1) != 1:
        lights = lights.contiguous()
    small = {k: params[k].contiguous() for k in (
        "eye_pos", "light_proj_view", "right", "up", "direction", "near",
        "near_wh")}
    keep.update(lights=lights, **small)
    a = ShadeRefArgs()
    a.planes[:] = [t.data_ptr() for t in planes]
    a.strides[:] = [st for t in planes for st in t.stride()]
    a.depth, a.depth_strides[:] = gbuf.depth.data_ptr(), gbuf.depth.stride()
    a.ssao, a.ssao_strides[:] = ssao.data_ptr(), ssao.stride()
    a.out, a.dbg = keep["out"].data_ptr(), _ptr(keep.get("dbg"))
    a.lights = lights.data_ptr()
    a.eye, a.light_pv = _ptr(small["eye_pos"]), _ptr(small["light_proj_view"])
    a.right, a.up = _ptr(small["right"]), _ptr(small["up"])
    a.direction, a.near = _ptr(small["direction"]), _ptr(small["near"])
    a.near_wh = _ptr(small["near_wh"])
    a.h, a.w = h, w
    a.light_stride, a.n_lights = lights.stride(0), n_lights
    if shadow_map is not None:
        s = shadow_map.shape[0]
        if shadow_map.dim() != 2 or shadow_map.shape[1] != s \
                or not shadow_map.is_contiguous():
            raise ValueError(f"shading: a shadow map of "
                             f"{tuple(shadow_map.shape)} is not a "
                             "contiguous (S, S) plane")
        a.shadow, a.shadow_size = shadow_map.data_ptr(), s
        # calculate_shadow's tap offsets: the Python double dx * (1 / S),
        # rounded to float32 where the torch op adds it to a float plane
        texel = 1.0 / s
        a.tap_off[:] = [d * texel for dx_dy in POISSON for d in dx_dy]
    if ibl is not None:
        maps = {"irr": ibl.irradiance_faces, "env": ibl.environment_faces,
                "spec": ibl.specular_mips.data, "lut": ibl.brdf_lut}
        for k, t in maps.items():
            channels = 2 if k == "lut" else 3  # what the kernel reads
            if (t.dtype != torch.float32 or t.device != dev
                    or not t.is_contiguous() or t.shape[-1] < channels):
                raise ValueError(f"shading: the IBL map {k} "
                                 f"{tuple(t.shape)} {t.dtype} on {t.device} "
                                 f"must be contiguous float32 on {dev}")
            _int32_extent(k, t)
            setattr(a, k, t.data_ptr())
        mips = ibl.specular_mips
        if not 1 <= mips.num_levels <= MAX_LEVELS:
            raise ValueError(f"shading: {mips.num_levels} specular levels, "
                             f"the kernel takes 1 to {MAX_LEVELS}")
        a.has_ibl = 1
        a.irr_size, a.irr_c = maps["irr"].shape[1], maps["irr"].shape[-1]
        a.env_size, a.env_c = maps["env"].shape[1], maps["env"].shape[-1]
        a.spec_c, a.num_levels = maps["spec"].shape[-1], mips.num_levels
        a.sizes[:mips.num_levels] = [int(v) for v in mips.sizes]
        a.offsets[:mips.num_levels] = [int(v) for v in mips.offsets]
        a.lut_h, a.lut_w, a.lut_c = maps["lut"].shape
        keep.update(maps)
    return a, keep


def _shading_ref_cuda(gbuf, ssao, shadow_map, lights, num_lights, params,
                      ibl, debug=False):
    """K11: one launch on the current stream.  ``debug``: also write the
    REF_DEBUG channels and return (colour, the kept tensors)."""
    tensors = [getattr(gbuf, k) for k in GBUFFER_PLANES] + [
        gbuf.depth, ssao, lights, params["eye_pos"],
        params["light_proj_view"]] + (
        [shadow_map] if shadow_map is not None else [])
    dev = gbuf.depth.device
    for i, t in enumerate(tensors):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"shading: argument {i} is {t.dtype} on "
                             f"{t.device}, expected float32 on {dev}")
    a, keep = shade_ref_args(gbuf, ssao, shadow_map, lights, num_lights,
                             params, ibl, debug=debug)
    launch_shading_ref(a, keep["out"])
    return (keep["out"], keep) if debug else keep["out"]


def launch_shading_ref(a, like):
    """The C entry of csrc/shading_ref.cu on ``like``'s stream; one count."""
    lib = _build.library()
    if lib.mo_shading_ref_args_size() != ctypes.sizeof(ShadeRefArgs):
        raise RuntimeError("shading: ShadeRefArgs does not match "
                           "csrc/shading_ref.cu")
    fn = _build.function("mo_shading_ref",
                         [ctypes.POINTER(ShadeRefArgs), _build.P])
    _build.check("shading_ref", fn(ctypes.byref(a), _build.stream_of(like)))
    _build.count("shading_ref")
