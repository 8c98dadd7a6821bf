"""IBL precompute (port of ``mo_renderer_tpu/kernels/ibl.py``; the
reference's resources/shaders/ibl/{cubemap_brdflut,irradiance,
specular}.comp).  Plain PyTorch ops: the reference has no TPU kernel here.

Sample loops run in chunks of samples, sized like the reference's scan
steps, and add each chunk's sum in order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import sampling
from . import brdf

PI = float(np.pi)


def _face_grid(size: int, half_texel: bool, device=None):
    """(size, size, 2) uv grid per the reference's uv convention."""
    off = 0.5 if half_texel else 0.0
    t = (torch.arange(size, dtype=torch.float32, device=device) + off) / size
    v, u = torch.meshgrid(t, t, indexing="ij")
    return torch.stack([u, v], dim=-1)


def cube_directions(size: int, half_texel: bool = False, device=None):
    """(6, size, size, 3) normalized directions (getDirection table)."""
    uv = _face_grid(size, half_texel, device)
    d = torch.stack([sampling.cube_direction(f, uv) for f in range(6)])
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def equirect_to_cubemap(equirect, size: int = 512):
    """(H, W, C) equirect -> (6, size, size, C) cubemap (bilinear)."""
    return sampling.sample_equirect(
        equirect, cube_directions(size, device=equirect.device)
    )


def _chunk(p: int, num_samples: int) -> int:
    """Largest power-of-two sample chunk with ~4M sample points."""
    b = 1
    while b < num_samples and p * (b * 2) <= (1 << 22):
        b *= 2
    return b


def brdf_lut(size: int = 512, num_samples: int = 1024, device=None):
    """(size, size, 3): rg = GGX scale/bias, b = Charlie sheen
    (ibl/cubemap_brdflut.comp:104-140: NoV = u, roughness = 1 - v)."""
    t = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    rough, nov = torch.meshgrid(1.0 - t, t, indexing="ij")
    nov = torch.clamp(nov, min=1e-6)
    v = torch.stack([torch.sqrt(1.0 - nov * nov), torch.zeros_like(nov), nov], -1)
    n_b = torch.tensor([0.0, 0.0, 1.0], device=device).expand(v.shape)
    dot_nv = torch.clamp(v[..., 2], min=0.0)

    lut = torch.zeros(rough.shape + (3,), dtype=torch.float32, device=device)
    b = _chunk(size * size, num_samples)
    for s0 in range(0, num_samples, b):
        i = torch.arange(s0, min(s0 + b, num_samples), device=device)
        k = i.shape[0]
        xi = brdf.hammersley2d(i[:, None, None].expand(k, size, size),
                               num_samples)
        r = rough.expand(k, size, size)
        vb, nb = v.expand(k, size, size, 3), n_b.expand(k, size, size, 3)
        h = brdf.importance_sample_ggx(xi, r, nb)
        l = 2.0 * brdf.dot3(vb, h)[..., None] * h - vb
        dot_nl = torch.clamp(l[..., 2], min=0.0)
        dot_vh = torch.clamp(brdf.dot3(vb, h), min=0.0)
        dot_nh = torch.clamp(h[..., 2], min=0.0)
        g = brdf.g_schlicksmith_ggx_ibl(dot_nl, dot_nv, r)
        g_vis = (g * dot_vh) / torch.clamp(dot_nh * dot_nv, min=1e-8)
        fc = (1.0 - dot_vh) ** 5
        ok = dot_nl > 0.0
        a = torch.where(ok, (1.0 - fc) * g_vis, 0.0)
        bb = torch.where(ok, fc * g_vis, 0.0)
        hc = brdf.importance_sample_charlie(xi, r, nb)
        lc = 2.0 * brdf.dot3(vb, hc)[..., None] * hc - vb
        c_nl = torch.clamp(lc[..., 2], min=0.0)
        c_vh = torch.clamp(brdf.dot3(vb, hc), min=0.0)
        c_nh = torch.clamp(hc[..., 2], min=0.0)
        d_ch = brdf.d_charlie(r, c_nh)
        v_ash = brdf.v_ashikhmin(c_nl, dot_nv)
        c = torch.where(c_nl > 0.0, v_ash * d_ch * c_nl * c_vh, 0.0)
        lut = lut + torch.stack([a, bb, c], -1).sum(0)
    return lut / num_samples


def _env_basis(env_faces, basis_size: int):
    """Downsample env to (6*b*b, 3) colors + dirs + solid angles."""
    dev = env_faces.device
    s = env_faces.shape[1]
    f = s // basis_size
    c = min(env_faces.shape[-1], 3)
    small = env_faces[..., :3].reshape(
        6, basis_size, f, basis_size, f, c
    ).mean(dim=(2, 4))
    dirs = cube_directions(basis_size, half_texel=True, device=dev).reshape(-1, 3)
    uv = _face_grid(basis_size, True, dev) * 2.0 - 1.0
    r2 = uv[..., 0] ** 2 + uv[..., 1] ** 2 + 1.0
    sa = (2.0 / basis_size) ** 2 / (r2 ** 1.5)
    return small.reshape(-1, c), dirs, sa.reshape(-1).repeat(6)


def irradiance_map(env_faces, out_size: int = 128, basis_size: int = 16):
    """(6, out, out, 3) storing E/pi (irradiance.comp:55 normalization)."""
    colors, dirs, sa = _env_basis(env_faces, basis_size)
    out_dirs = cube_directions(out_size, device=env_faces.device).reshape(-1, 3)
    weights = sa[None, :] * torch.clamp(out_dirs @ dirs.t(), min=0.0)
    irr = (weights @ colors) / PI
    return irr.reshape(6, out_size, out_size, colors.shape[-1])


def _env_mip_chain(env_faces, min_size: int = 4) -> sampling.MipCube:
    mips = [env_faces[..., :3]]
    cur = env_faces[..., :3]
    while cur.shape[1] > min_size:
        s = cur.shape[1] // 2
        cur = cur.reshape(6, s, 2, s, 2, cur.shape[-1]).mean(dim=(2, 4))
        mips.append(cur)
    return sampling.MipCube.from_mips(mips)


def _prefilter_level(env_quad, dirs, roughness, num_samples, env_size):
    """Filtered importance sampling over a batch of output texels
    (N = R = V), sampling the merged RGBE quad chain of the environment."""
    p = dirs.shape[0]
    b = _chunk(p, num_samples)
    dirs_b = dirs[None]
    omega_p = 4.0 * PI / (6.0 * env_size * env_size)
    color = torch.zeros((p, 3), dtype=torch.float32, device=dirs.device)
    weight = torch.zeros((p,), dtype=torch.float32, device=dirs.device)
    n_steps = (num_samples + b - 1) // b
    for step in range(n_steps):
        i = step * b + torch.arange(b, device=dirs.device)[:, None]
        xi = brdf.hammersley2d(i.expand(b, p), num_samples)
        h = brdf.importance_sample_ggx(xi, roughness, dirs_b)
        l = 2.0 * brdf.dot3(dirs_b, h)[..., None] * h - dirs_b
        l = l / torch.linalg.vector_norm(l, dim=-1, keepdim=True)
        ndotl = torch.clamp(brdf.dot3(dirs_b, l), min=0.0)
        ndoth = torch.clamp(brdf.dot3(dirs_b, h), min=1e-4)
        d = brdf.distribution_ggx(dirs_b, h, roughness)
        pdf = torch.clamp(d * ndoth / (4.0 * ndoth), min=1e-8)
        omega_s = 1.0 / (num_samples * pdf)
        lod = torch.clamp(0.5 * torch.log2(omega_s / omega_p), 0.0, 12.0)
        env = sampling.sample_mipcube_quad_merged_lod(env_quad, l, lod)
        w = torch.where(ndotl > 0.0, ndotl, 0.0)
        color = color + (env * w[..., None]).sum(0)
        weight = weight + w.sum(0)
    return color / torch.clamp(weight, min=1e-8)[..., None]


def specular_prefilter(env_faces, num_mips: int = 8,
                       num_samples: int = 1024) -> sampling.MipCube:
    """GGX-prefiltered mip chain: mip i at native size env/2^i with
    roughness i/(num_mips-1); mip 0 = the environment (mirror)."""
    dev = env_faces.device
    env_size = env_faces.shape[1]
    env_quad = sampling.MipCubeQuadMerged.from_quad(
        sampling.MipCubeQuad.from_mipcube(_env_mip_chain(env_faces))
    )
    sizes, dirs_l, rough_l = [], [], []
    for i in range(1, num_mips):
        size = max(env_size >> i, 1)
        sizes.append(size)
        d = cube_directions(size, device=dev).reshape(-1, 3)
        dirs_l.append(d)
        rough_l.append(torch.full((d.shape[0],), i / (num_mips - 1),
                                  dtype=torch.float32, device=dev))
    flat = _prefilter_level(
        env_quad, torch.cat(dirs_l), torch.cat(rough_l), num_samples, env_size
    )
    mips = [env_faces[..., :3]]
    off = 0
    for size in sizes:
        n = 6 * size * size
        mips.append(flat[off : off + n].reshape(6, size, size, 3))
        off += n
    return sampling.MipCube.from_mips(mips)


# --- spherical harmonics (order 2) -------------------------------------------

_SH_C = (0.282095, 0.488603, 1.092548, 0.315392, 0.546274)


def _sh9_basis(dirs):
    """dirs (..., 3) -> (..., 9) real SH basis values."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    return torch.stack(
        [
            torch.full_like(x, _SH_C[0]),
            _SH_C[1] * y,
            _SH_C[1] * z,
            _SH_C[1] * x,
            _SH_C[2] * x * y,
            _SH_C[2] * y * z,
            _SH_C[3] * (3.0 * z * z - 1.0),
            _SH_C[2] * x * z,
            _SH_C[4] * (x * x - y * y),
        ],
        dim=-1,
    )


def sh9_project_cube(faces):
    """Project a cubemap (6, S, S, C) onto SH9: returns (9, C) coeffs."""
    s = faces.shape[1]
    uv = _face_grid(s, True, faces.device)
    fx = uv[..., 0] * 2.0 - 1.0
    fy = uv[..., 1] * 2.0 - 1.0
    dw = 4.0 / (s * s * torch.pow(fx * fx + fy * fy + 1.0, 1.5))
    basis = _sh9_basis(cube_directions(s, half_texel=True, device=faces.device))
    contrib = basis[..., :, None] * faces[..., None, :] * dw[None, :, :, None, None]
    return contrib.sum(dim=(0, 1, 2))


def sh9_eval(coeffs, dirs):
    """Evaluate the SH9 reconstruction at dirs (..., 3) -> (..., C)."""
    return _sh9_basis(dirs) @ coeffs
