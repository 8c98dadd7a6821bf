"""BRDF library (port of ``mo_renderer_tpu/kernels/brdf.py``, itself a
port of resources/shaders/include/pbr.glsl).  Every function is
vectorized over leading batch dims; vectors are (..., 3)."""

from __future__ import annotations

import torch

PI = 3.14159265358979323846


def dot3(a, b):
    return (a * b).sum(-1)


def normalize(v, eps: float = 0.0):
    n = torch.sqrt((v * v).sum(-1, keepdim=True))
    if eps:
        n = torch.clamp(n, min=eps)
    return v / n


def reflect_glsl(i, n):
    """GLSL reflect(I, N) = I - 2*dot(N,I)*N."""
    return i - 2.0 * dot3(n, i)[..., None] * n


def distribution_ggx(n, h, roughness):
    """pbr.glsl:75-87."""
    a = roughness * roughness
    a2 = a * a
    ndoth = torch.clamp(dot3(n, h), min=0.0)
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom)


def geometry_schlick_ggx(ndotv, roughness):
    """pbr.glsl:89-98 — direct-lighting k = (r+1)^2 / 8."""
    r = roughness + 1.0
    k = (r * r) / 8.0
    return ndotv / (ndotv * (1.0 - k) + k)


def geometry_smith(n, v, l, roughness):
    """pbr.glsl:100-108."""
    ndotv = torch.clamp(dot3(n, v), min=0.0)
    ndotl = torch.clamp(dot3(n, l), min=0.0)
    return geometry_schlick_ggx(ndotv, roughness) * geometry_schlick_ggx(
        ndotl, roughness
    )


def g_schlicksmith_ggx_ibl(ndotl, ndotv, roughness):
    """IBL variant with k = r^2/2 (ibl/cubemap_brdflut.comp:62-68)."""
    k = (roughness * roughness) / 2.0
    gl = ndotl / (ndotl * (1.0 - k) + k)
    gv = ndotv / (ndotv * (1.0 - k) + k)
    return gl * gv


def fresnel_schlick(cos_theta, f0):
    """pbr.glsl:153-156."""
    c = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    return f0 + (1.0 - f0) * (c**5)[..., None]


def fresnel_schlick_roughness(cos_theta, f0, roughness):
    """pbr.glsl:158-161."""
    c = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    fmax = torch.maximum(1.0 - roughness[..., None], f0)
    return f0 + (fmax - f0) * (c**5)[..., None]


def glsl_random(co):
    """The canonical one-liner hash (pbr.glsl:111-119): co (..., 2)."""
    dt = co[..., 0] * 12.9898 + co[..., 1] * 78.233
    sn = torch.remainder(dt, 3.14)
    v = torch.sin(sn) * 43758.5453
    return v - torch.floor(v)


def hammersley2d(i, n):
    """pbr.glsl:122-131; i int tensor (uint32 values), n int -> (..., 2).
    The 32-bit radical inverse runs in int64 with explicit masks."""
    i = i.to(torch.int64)
    m32 = 0xFFFFFFFF
    bits = ((i << 16) | (i >> 16)) & m32
    for mask, sh in (
        (0x55555555, 1), (0x33333333, 2), (0x0F0F0F0F, 4), (0x00FF00FF, 8),
    ):
        bits = ((bits & mask) << sh) | ((bits & (mask << sh) & m32) >> sh)
    rdi = bits.to(torch.float32) * 2.3283064365386963e-10
    return torch.stack([i.to(torch.float32) / n, rdi], dim=-1)


def _tangent_frame_sample(h_local, normal):
    up = torch.where(
        (normal[..., 2].abs() < 0.999)[..., None],
        torch.tensor([0.0, 0.0, 1.0], device=normal.device),
        torch.tensor([1.0, 0.0, 0.0], device=normal.device),
    ).expand(normal.shape)
    tangent_x = normalize(torch.cross(up, normal, dim=-1), eps=1e-20)
    tangent_y = normalize(torch.cross(normal, tangent_x, dim=-1), eps=1e-20)
    return normalize(
        tangent_x * h_local[..., 0:1] + tangent_y * h_local[..., 1:2]
        + normal * h_local[..., 2:3]
    )


def importance_sample_ggx(xi, roughness, normal):
    """pbr.glsl:135-151 — GGX half-vector sample about ``normal``, with
    the reference's random(normal.xz)*0.1 phi jitter."""
    alpha = roughness * roughness
    phi = 2.0 * PI * xi[..., 0] + glsl_random(normal[..., ::2]) * 0.1
    cos_theta = torch.sqrt(
        (1.0 - xi[..., 1]) / (1.0 + (alpha * alpha - 1.0) * xi[..., 1])
    )
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    h = torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta],
        dim=-1,
    )
    return _tangent_frame_sample(h, normal)


def v_ashikhmin(ndotl, ndotv):
    """ibl/cubemap_brdflut.comp:71-73."""
    return torch.clamp(1.0 / (4.0 * (ndotl + ndotv - ndotl * ndotv)), 0.0, 1.0)


def d_charlie(sheen_roughness, ndoth):
    """ibl/cubemap_brdflut.comp:75-81."""
    r = torch.clamp(sheen_roughness, min=1e-6)
    inv_r = 1.0 / r
    sin2h = 1.0 - ndoth * ndoth
    return (2.0 + inv_r) * torch.pow(
        torch.clamp(sin2h, min=0.0), inv_r * 0.5
    ) / (2.0 * PI)


def importance_sample_charlie(xi, roughness, normal):
    """ibl/cubemap_brdflut.comp:83-101."""
    alpha = roughness * roughness
    phi = 2.0 * PI * xi[..., 0]
    sin_theta = torch.pow(xi[..., 1], alpha / (2.0 * alpha + 1.0))
    cos_theta = torch.sqrt(torch.clamp(1.0 - sin_theta * sin_theta, min=0.0))
    h = torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta],
        dim=-1,
    )
    return _tangent_frame_sample(h, normal)


def surface_shading(
    position, base_color, normal, metallic, roughness,
    light_type, light_position, light_color, light_direction,
    light_attenuation, eye_pos, spot_exponent,
):
    """Cook-Torrance direct lighting — pbr.glsl surfaceShading (:183-243)
    for ONE light (light_* are (3,)/(4,)/() tensors).  Reproduces the
    reference's direction double-sign-flip: L = normalize(light_direction)
    for directional lights."""
    n = normal
    v = normalize(eye_pos - position, eps=1e-20)
    f0 = 0.04 + (base_color - 0.04) * metallic[..., None]

    pos_to_light = light_position - position
    d = torch.sqrt(torch.clamp(dot3(pos_to_light, pos_to_light), min=1e-20))
    is_dir = light_type == 0.0
    is_point = light_type == 1.0

    l_dir = normalize(light_direction, eps=1e-20)
    l_pos = pos_to_light / d[..., None]
    l = torch.where(is_dir, l_dir, l_pos)

    att_poly = (
        light_attenuation[0]
        + light_attenuation[1] * d
        + light_attenuation[2] * d * d
    )
    spot = torch.pow(torch.clamp(dot3(l_pos, l_dir), min=0.0), spot_exponent)
    attenuation = torch.where(
        is_dir,
        light_attenuation[0].expand_as(d),
        torch.where(is_point, 1.0 / att_poly, spot / att_poly),
    )

    h = normalize(v + l, eps=1e-20)
    radiance = light_color * attenuation[..., None]

    ndf = distribution_ggx(n, h, roughness)
    g = geometry_smith(n, v, l, roughness)
    f = fresnel_schlick(torch.clamp(dot3(h, v), min=0.0), f0)
    kd = (1.0 - f) * (1.0 - metallic[..., None])

    num = ndf[..., None] * g[..., None] * f
    denom = (
        4.0 * torch.clamp(dot3(n, v), min=0.0)
        * torch.clamp(dot3(n, l), min=0.0) + 1e-4
    )
    specular = num / denom[..., None]
    ndotl = torch.clamp(dot3(n, l), min=0.0)
    return (kd * base_color / PI + specular) * radiance * ndotl[..., None]


def image_based_lighting(
    position, base_color, normal, metallic, roughness, occlusion,
    eye_pos, irradiance_map_sample, prefiltered_sample, brdf_sample,
):
    """Split-sum ambient (pbr.glsl:245-271) from pre-sampled maps."""
    v = normalize(eye_pos - position, eps=1e-20)
    f0 = 0.04 + (base_color - 0.04) * metallic[..., None]
    ndotv = torch.clamp(dot3(normal, v), min=0.0)
    f = fresnel_schlick_roughness(ndotv, f0, roughness)
    kd = (1.0 - f) * (1.0 - metallic[..., None])
    diffuse = irradiance_map_sample * base_color
    specular = prefiltered_sample * (
        f * brdf_sample[..., 0:1] + brdf_sample[..., 1:2]
    )
    return (kd * diffuse + specular) * occlusion[..., None]


def env_brdf_poly(ndotv, roughness):
    """Environment-BRDF (scale, bias) from the fitted Chebyshev polynomial
    (see the reference's kernels/brdf.py); returns (..., 2)."""
    from .env_brdf_coeffs import COEFFS, DEG

    half = 0.5 / 512.0  # texel-centre clamp of the reference's 512^2 LUT
    x = 2.0 * torch.sqrt(torch.clamp(ndotv, half, 1.0 - half)) - 1.0
    y = 2.0 * torch.sqrt(torch.clamp(roughness, half, 1.0 - half)) - 1.0

    def cheb_all(t):
        ts = [torch.ones_like(t), t]
        for _ in range(DEG - 1):
            ts.append(2.0 * t * ts[-1] - ts[-2])
        return ts

    tx = cheb_all(x)
    ty = cheb_all(y)
    out = []
    for c in range(2):
        acc = 0.0
        for i in range(DEG + 1):
            row = COEFFS[2 * i + c]
            inner = row[0] * tx[0]
            for j in range(1, DEG + 1):
                inner = inner + row[j] * tx[j]
            acc = acc + ty[i] * inner
        out.append(acc)
    return torch.stack(out, dim=-1)


def ibl_reflection_dir(position, normal, eye_pos):
    """The reference's R = reflect(V, N) with V = eye - pos
    (pbr.glsl:248-249), kept verbatim for image parity."""
    v = normalize(eye_pos - position, eps=1e-20)
    return reflect_glsl(v, normal)
