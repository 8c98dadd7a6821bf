// Device helpers of the two shading kernels: csrc/shading.cu (K9, the
// fast path) and csrc/shading_ref.cu (K11, the reference sampling path).
//
// Both units compile these with multiply-add contraction and division and
// roots to 2 ulps (kernels/_build.py UNIT_FLAGS).  The pinned helpers (p*)
// round once per operation under any flags, so what feeds a compare or an
// index rounds as the plain version's torch op does.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// internal linkage in each unit that includes it
namespace {

// GpuLight row columns (scene_buffers.py): type, spot exponent, position,
// colour, direction, attenuation
constexpr int kLightType = 0;
constexpr int kLightSpot = 2;
constexpr int kLightPos = 4;
constexpr int kLightColor = 8;
constexpr int kLightDir = 12;
constexpr int kLightAtt = 16;
constexpr int kLightCols = kLightAtt + 3;  // the columns the kernels read
// the light rows' shared memory (dynamic), at most: a table longer than
// kLightChunkRows streams through it a chunk at a time (shade_lights, the
// kernels' kStreamed instances)
constexpr int kMaxLightBytes = 40 * 1024;
constexpr int kLightChunkRows = kMaxLightBytes / (kLightCols * 4);
constexpr int kMaxLevels = 16;  // specular mip levels

constexpr float kPi = (float)3.14159265358979323846;
constexpr float kF0 = (float)0.04;    // dielectric F0
constexpr float kTm0 = (float)0.155;  // tonemap_unreal
constexpr float kTm1 = (float)1.019;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return v3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 divs(V3 a, float s) {
  return v3(a.x / s, a.y / s, a.z / s);
}
__device__ __forceinline__ V3 load3(const float* p) {
  return v3(p[0], p[1], p[2]);
}
// (a * b).sum(-1)
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
// torch.clamp passes a NaN on; fminf / fmaxf would drop it
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ float maxf(float v, float lo) {
  return v < lo ? lo : v;
}
// brdf.normalize(v, eps=1e-20)
__device__ __forceinline__ V3 normalize_eps(V3 v) {
  return divs(v, maxf(sqrtf(dot3(v, v)), (float)1e-20));
}

// ---- pinned arithmetic: one rounding per operation, never contracted ----

__device__ __forceinline__ float pmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float padd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float psub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float pdiv(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ V3 padd3(V3 a, V3 b) {
  return v3(padd(a.x, b.x), padd(a.y, b.y), padd(a.z, b.z));
}
__device__ __forceinline__ V3 psub3(V3 a, V3 b) {
  return v3(psub(a.x, b.x), psub(a.y, b.y), psub(a.z, b.z));
}
__device__ __forceinline__ V3 pscale3(V3 a, float s) {
  return v3(pmul(a.x, s), pmul(a.y, s), pmul(a.z, s));
}
// (a * b).sum(-1) of a (..., 3) plane as PyTorch's CUDA reduction adds it:
// two threads an output, (x + z) + y (pinned)
__device__ __forceinline__ float pdot3(V3 a, V3 b) {
  return padd(padd(pmul(a.x, b.x), pmul(a.z, b.z)), pmul(a.y, b.y));
}
// brdf.normalize(v, eps=1e-20) as the plain version computes it on the
// card (pinned)
__device__ __forceinline__ V3 pnormalize_eps(V3 v) {
  const float s = maxf(__fsqrt_rn(pdot3(v, v)), (float)1e-20);
  return v3(pdiv(v.x, s), pdiv(v.y, s), pdiv(v.z, s));
}

// The per-frame constants, in shared memory once per block.
struct FrameConsts {
  float eye[3];
  float light_pv[16];
  float right[3], up[3], direction[3];
  float near_;
  float near_wh[2];
  float sh9[27];
  int sizes[kMaxLevels];
  int offsets[kMaxLevels];
};

// ---- sampling (device/sampling.py) ----------------------------------------

struct FaceUV {
  int face;
  float u, v;
};

// cube_face_uv: the GL cube sampling rule (pinned)
__device__ FaceUV cube_face_uv(V3 d) {
  const float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  const bool is_x = (ax >= ay) && (ax >= az);
  const bool is_y = !is_x && (ay >= az);
  FaceUV r;
  r.face = is_x ? (d.x >= 0.0f ? 0 : 1)
                : (is_y ? (d.y >= 0.0f ? 2 : 3) : (d.z >= 0.0f ? 4 : 5));
  const float ma = maxf(is_x ? ax : (is_y ? ay : az), (float)1e-20);
  const float sc = is_x ? (d.x >= 0.0f ? -d.z : d.z)
                        : (is_y ? d.x : (d.z >= 0.0f ? d.x : -d.x));
  const float tc = is_y ? (d.y >= 0.0f ? d.z : -d.z) : -d.y;
  r.u = pmul(padd(pdiv(sc, ma), 1.0f), 0.5f);
  r.v = pmul(padd(pdiv(tc, ma), 1.0f), 0.5f);
  return r;
}

// the mip level of the specular taps, floor(clamp(roughness * 7, 0, nl - 1))
__device__ __forceinline__ int mip_level(float rough, int nl) {
  return (int)floorf(clampf(pmul(rough, 7.0f), 0.0f, (float)(nl - 1)));
}

// ---- sky rays (_sky_dirs) ---------------------------------------------------

// the skybox ray through the frame point (u, v) in [0, 1]^2 (the plain
// version's (col + 0.5) / width, (row + 0.5) / height, which each kernel
// computes as its plain version's division does), normalized (pinned)
__device__ V3 sky_ray(const FrameConsts& k, float u, float v) {
  const float y = psub(pmul(v, 2.0f), 1.0f);
  const float x = psub(pmul(u, 2.0f), 1.0f);
  const float hw = pdiv(k.near_wh[0], 2.0f);
  const float hh = pdiv(k.near_wh[1], 2.0f);
  const V3 d = psub3(padd3(pscale3(load3(k.right), pmul(x, hw)),
                           pscale3(load3(k.up), pmul(y, hh))),
                     pscale3(load3(k.direction), k.near_));
  const float inv = pdiv(1.0f, __fsqrt_rn(maxf(pdot3(d, d), (float)1e-20)));
  return pscale3(d, inv);
}

// ---- BRDF (kernels/brdf.py) -------------------------------------------------

// ibl_reflection_dir: reflect(V, N) with V = normalize(eye - pos) (pinned)
__device__ __forceinline__ V3 reflection_dir(V3 pos, V3 n, V3 eye) {
  const V3 v = pnormalize_eps(psub3(eye, pos));
  return psub3(v, pscale3(n, pmul(2.0f, pdot3(n, v))));
}

// c ** 5 as products: what powf(c, 5) rounds once, within a few ulps
__device__ __forceinline__ float pow5(float c) {
  const float c2 = c * c;
  return (c2 * c2) * c;
}

// x ** e for the spot cone, x >= 0: exp2(e * log2(x)) on the special
// function unit; powf's x ** 0 = 1 kept where log2(0) * 0 would be a NaN
__device__ __forceinline__ float spot_pow(float x, float e) {
  return e == 0.0f ? 1.0f : __powf(x, e);
}

__device__ __forceinline__ float schlick_ggx(float ndotv, float k) {
  return ndotv / (ndotv * (1.0f - k) + k);
}

// F0 = 0.04 + (base - 0.04) * metallic
__device__ __forceinline__ V3 fresnel_f0(V3 base, float metallic) {
  return add(v3(kF0, kF0, kF0), scale(sub(base, v3(kF0, kF0, kF0)), metallic));
}

// surface_shading for one light row; v = normalize(eye - pos), f0 as above
__device__ V3 surface_shading(V3 pos, V3 base, V3 n, float metallic,
                              float rough, V3 v, V3 f0, const float* row) {
  const float type = row[kLightType];
  const V3 lp = load3(row + kLightPos);
  const V3 lc = load3(row + kLightColor);
  const V3 ld = load3(row + kLightDir);
  const float a0 = row[kLightAtt], a1 = row[kLightAtt + 1],
              a2 = row[kLightAtt + 2];
  const V3 ptl = sub(lp, pos);
  const float d = sqrtf(maxf(dot3(ptl, ptl), (float)1e-20));
  const bool is_dir = type == 0.0f;
  const bool is_point = type == 1.0f;
  const V3 l_dir = normalize_eps(ld);
  const V3 l_pos = divs(ptl, d);
  const V3 l = is_dir ? l_dir : l_pos;
  const float att_poly = (a0 + a1 * d) + (a2 * d) * d;
  const float spot = spot_pow(maxf(dot3(l_pos, l_dir), 0.0f), row[kLightSpot]);
  const float attenuation =
      is_dir ? a0 : (is_point ? 1.0f / att_poly : spot / att_poly);
  const V3 hv = normalize_eps(add(v, l));
  const V3 radiance = scale(lc, attenuation);

  // distribution_ggx
  const float a = rough * rough;
  const float a2g = a * a;
  const float ndoth = maxf(dot3(n, hv), 0.0f);
  const float denom_d = (ndoth * ndoth) * (a2g - 1.0f) + 1.0f;
  const float ndf = a2g / ((kPi * denom_d) * denom_d);
  // geometry_smith, k = (r + 1)^2 / 8
  const float r1 = rough + 1.0f;
  const float k = (r1 * r1) / 8.0f;
  const float ndotv = maxf(dot3(n, v), 0.0f);
  const float ndotl = maxf(dot3(n, l), 0.0f);
  const float g = schlick_ggx(ndotv, k) * schlick_ggx(ndotl, k);
  // fresnel_schlick
  const float c = clampf(1.0f - maxf(dot3(hv, v), 0.0f), 0.0f, 1.0f);
  const float c5 = pow5(c);
  const V3 f = add(f0, scale(v3(1.0f - f0.x, 1.0f - f0.y, 1.0f - f0.z), c5));
  const float om = 1.0f - metallic;
  const V3 kd = scale(v3(1.0f - f.x, 1.0f - f.y, 1.0f - f.z), om);
  const V3 num = scale(f, ndf * g);
  const float denom = ((4.0f * ndotv) * ndotl) + (float)1e-4;
  const V3 specular = divs(num, denom);
  const V3 diffuse = divs(mul(kd, base), kPi);
  return scale(mul(add(diffuse, specular), radiance), ndotl);
}

// image_based_lighting's split sum from its sampled inputs: the
// irradiance, the prefiltered colour and the environment BRDF's (scale,
// bias); ndotv = max(dot(n, v), 0)
__device__ __forceinline__ V3 split_sum(V3 base, V3 f0, float ndotv,
                                        float rough, float metallic,
                                        float occlusion, V3 irr, V3 pref,
                                        float lut0, float lut1) {
  const float c = clampf(1.0f - ndotv, 0.0f, 1.0f);
  const float c5 = pow5(c);
  const float om_r = 1.0f - rough;
  // torch.maximum passes a NaN on
  const V3 fmax = v3(om_r != om_r || om_r > f0.x ? om_r : f0.x,
                     om_r != om_r || om_r > f0.y ? om_r : f0.y,
                     om_r != om_r || om_r > f0.z ? om_r : f0.z);
  const V3 fr = add(f0, scale(sub(fmax, f0), c5));
  const V3 kd = scale(v3(1.0f - fr.x, 1.0f - fr.y, 1.0f - fr.z),
                      1.0f - metallic);
  const V3 diffuse = mul(irr, base);
  const V3 spec = mul(pref, add(scale(fr, lut0), v3(lut1, lut1, lut1)));
  return scale(add(mul(kd, diffuse), spec), occlusion);
}

// (ambient + lo * shadow) * ssao + emissive, then tonemap_unreal
__device__ __forceinline__ V3 combine_tonemap(V3 ambient, V3 lo, float shadow,
                                              float ao, V3 emis) {
  V3 col = scale(add(ambient, scale(lo, shadow)), ao);
  col = add(col, emis);
  return v3(col.x / (col.x + kTm0) * kTm1, col.y / (col.y + kTm0) * kTm1,
            col.z / (col.z + kTm0) * kTm1);
}

// the light rows' kLightCols columns into shared memory, by a block of
// ``n_threads``
__device__ __forceinline__ void load_lights(float* dst, const float* src,
                                            int n_lights, int stride,
                                            int tid, int n_threads) {
  for (int i = tid; i < n_lights * kLightCols; i += n_threads) {
    const int l = i / kLightCols;
    dst[i] = src[(size_t)l * stride + (i - l * kLightCols)];
  }
}

// What surface_shading reads of a pixel besides the light row.
struct Surface {
  V3 pos, base, n, v, f0;
  float metallic, rough;
};

// shade_lights: surface_shading summed over a light table of more rows
// than one chunk (``n_lights`` rows of stride ``stride``), in light order
// from zero, as the one-chunk kernels sum a table they hold whole.  The
// rows stream through ``smem`` kLightChunkRows at a time, each chunk
// loaded by the whole block between two barriers, so every thread of the
// block calls this, as often as any other, and ``lit`` says whether its
// pixel sums.
template <int kBlockThreads>
__device__ __forceinline__ V3 shade_lights(float* smem, const float* rows,
                                           int n_lights, int stride, int tid,
                                           bool lit, const Surface& s) {
  V3 lo = v3(0.0f, 0.0f, 0.0f);
  for (int c = 0; c < n_lights; c += kLightChunkRows) {
    const int n = min(kLightChunkRows, n_lights - c);
    __syncthreads();  // every thread is done with the rows before
    load_lights(smem, rows + (size_t)c * stride, n, stride, tid,
                kBlockThreads);
    __syncthreads();
    if (lit) {
      for (int l = 0; l < n; ++l) {
        lo = add(lo, surface_shading(s.pos, s.base, s.n, s.metallic, s.rough,
                                     s.v, s.f0, smem + l * kLightCols));
      }
    }
  }
  return lo;
}

}  // namespace
