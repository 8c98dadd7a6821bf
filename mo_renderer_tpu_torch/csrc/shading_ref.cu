// The reference sampling path's deferred shading pass for the PyTorch
// port's frames: G-buffer planes, SSAO, the raw shadow map and the IBL
// maps in, clamped tonemapped colour out.
//
// Replaces mo_renderer_tpu/passes/shading.py shading_pass:149 -- K11.  The
// reference has no pallas_call here: XLA fuses the jnp code on the TPU.
// The port's plain version (passes/shading.py, _shading_ref_plain) runs it
// as ~1100-1500 PyTorch launches a 1080p frame, each one pass over an
// (H, W) or (H, W, 3) plane; this kernel is all of it, in one launch.
//
// What bounds it on this card: bytes in principle -- per pixel the depth
// read and 3 floats written, per lit pixel 15 floats of G-buffer planes and
// SSAO read, and the map texels the samples touch (the shadow map's 16 MB
// and the IBL maps stay in the 50 MB L2) -- in practice latency: a lit
// pixel makes 36 dependent shadow-map loads (9 PCF taps of 4 texels), 12
// irradiance, 24 specular and 8 BRDF-LUT loads, after a light loop of
// ~150 FP32 operations a light.
//
// Design (what K9's two designs taught): one thread a pixel, blocks of
// 32 x 8 pixels so that a warp's taps fall on neighbouring texels; the frame's
// constants (light rows, light_pv, eye, camera basis) in shared memory
// once a block, the level sizes and offsets and the PCF tap offsets by
// value in the arguments; a register cap (__launch_bounds__, kMinBlocks)
// chosen by timing (PERF.md).  A sky pixel (depth >= 1, with IBL) samples
// the environment and nothing else: the plain version computes its lights,
// shadow and ambient and then discards them (where(depth >= 1, sky, ...)).
// The G-buffer planes, depth and SSAO are read where they are, through
// their strides (32-bit offsets: the wrapper checks every extent).
// Nothing is read on the host and nothing is allocated here, so a CUDA
// graph captures the launch.  A debug output (null on the frame's path)
// keeps each pixel's discrete choices -- PCF compares and tap texels, cube
// faces, mip level, texel anchors -- for a check against the plain
// version's.
//
// Arithmetic: the unit builds with -fmad=false and IEEE division and roots
// (kernels/_build.py), so nearly every operation rounds once as its torch
// op does.  Two shared helpers do not (shading_common.cuh): the spot cone's
// power is __powf, and pow5 (Schlick's (1 - c)^5) is a chain of products
// where torch calls pow.  Both are continuous and feed no compare or index,
// so they stay within the tolerance and never move a discrete choice.  The
// discontinuities -- each texel anchor floor(uv * size - 0.5),
// the cube face (ax >= ay, ax >= az, signs), the mip level floor, the PCF
// compare `current > closest` and the sky test depth >= 1 -- then follow
// the plain version exactly.  Where the plain version's order is a
// library's, the kernel takes the card's: the light projection [wp, 1] @
// light_pv.T (cuBLAS) is a multiply-add chain in k order, a division by a
// Python scalar (the sky rays' / width, the PCF count's / 9) is a multiply
// by its float reciprocal as PyTorch's CUDA division by a scalar is, and
// each PCF tap offset is the Python double dx / size rounded to float
// (the wrapper's tap_off).  Sampling follows device/sampling.py:
// sample_cubemap and sample_bilinear clamp the texel indices, not the
// fractions.
#include "shading_common.cuh"

// the debug output's channels per pixel (-1 where not evaluated)
constexpr int kDbgPcf = 0;      // PCF compare bits 0-8, beyond_far bit 9
constexpr int kDbgTaps = 1;     // 9 PCF tap anchors
constexpr int kDbgFaces = 10;   // irradiance | specular << 4 | sky << 8
constexpr int kDbgLevel = 11;   // the lower mip level
constexpr int kDbgIrr = 12;     // anchors: irradiance, specular l0, l1,
constexpr int kDbgSpec0 = 13;   // the BRDF LUT, the sky's environment
constexpr int kDbgSpec1 = 14;
constexpr int kDbgLut = 15;
constexpr int kDbgEnv = 16;
constexpr int kDbgChannels = 17;

// What the kernel reads, filled by passes/shading.py shade_ref_args (its
// ShadeRefArgs ctypes structure mirrors this one field for field).
struct ShadeRefArgs {
  // G-buffer planes (H, W, 3): position, normal, base colour, emissive, orm
  const float* planes[5];
  int strides[5][3];  // elements: row, column, channel
  const float* depth;  // (H, W)
  int depth_strides[2];
  const float* ssao;  // (H, W)
  int ssao_strides[2];
  float* out;  // (H, W, 3) contiguous
  int* dbg;    // (H, W, kDbgChannels) contiguous, or null
  const float* lights;
  const float* eye;       // (3,)
  const float* light_pv;  // (4, 4) row-major
  const float* right;     // (3,)
  const float* up;        // (3,)
  const float* direction; // (3,)
  const float* near_;     // ()
  const float* near_wh;   // (2,)
  const float* shadow;    // (S, S) contiguous, or null: no shadow
  const float* irr;       // (6, I, I, irr_c) irradiance cube
  const float* env;       // (6, E, E, env_c) environment cube
  const float* spec;      // (texels, spec_c) specular mip chain, flat
  const float* lut;       // (lut_h, lut_w, lut_c) BRDF LUT
  float tap_off[9][2];    // float32(Poisson (dx, dy) * (1 / S))
  int sizes[kMaxLevels], offsets[kMaxLevels];  // the specular levels
  int h, w;
  int shadow_size;
  int has_ibl;
  int irr_size, irr_c, env_size, env_c, spec_c, num_levels;
  int lut_h, lut_w, lut_c;
  int light_stride, n_lights;
};

namespace {

constexpr int kBlockW = 32;
constexpr int kBlockH = 8;
constexpr int kThreads = kBlockW * kBlockH;
constexpr int kMinBlocks = 4;  // 256 threads x 4 blocks: 64 registers

__device__ __forceinline__ V3 plane3(const ShadeRefArgs& a, int k, int y,
                                     int x) {
  const float* p = a.planes[k] + y * a.strides[k][0] + x * a.strides[k][1];
  const int c = a.strides[k][2];
  return v3(__ldg(p), __ldg(p + c), __ldg(p + 2 * c));
}

// the texel anchor floor(t * size - 0.5) as the debug output packs it
__device__ __forceinline__ int pack_anchor(int x0, int y0) {
  return (int)(((unsigned)y0 & 0xFFFFu) << 16 | ((unsigned)x0 & 0xFFFFu));
}

// One bilinear axis of sample_cubemap / sample_bilinear: the anchor
// floor(t * n - 0.5), its fraction, and the two indices clamped to the
// edge (the fraction is not).
struct Axis {
  int i0, i1, anchor;
  float f;
};
__device__ __forceinline__ Axis axis(float t, int n) {
  const float x = t * (float)n - 0.5f;
  const float x0 = floorf(x);
  Axis r;
  r.f = x - x0;
  r.anchor = (int)x0;
  r.i0 = min(max(r.anchor, 0), n - 1);
  r.i1 = min(max(r.anchor + 1, 0), n - 1);
  return r;
}

// _bilerp of the first three channels of four rows of ``c`` floats
__device__ __forceinline__ V3 bilerp3(const float* t00, const float* t10,
                                      const float* t01, const float* t11,
                                      float fx, float fy) {
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  float r[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float top = __ldg(t00 + ch) * gx + __ldg(t10 + ch) * fx;
    const float bot = __ldg(t01 + ch) * gx + __ldg(t11 + ch) * fx;
    r[ch] = top * gy + bot * fy;
  }
  return v3(r[0], r[1], r[2]);
}

// sample_cubemap on the s x s faces from row ``off`` of a flat table of
// ``c`` floats a texel (the specular chain's level: _sample_mipcube_level)
__device__ V3 sample_face(const float* data, int off, int s, int c, FaceUV fc,
                          int* anchor) {
  const Axis ax = axis(fc.u, s), ay = axis(fc.v, s);
  const int base = off + fc.face * s * s;
  const float* r0 = data + (base + ay.i0 * s) * c;
  const float* r1 = data + (base + ay.i1 * s) * c;
  *anchor = pack_anchor(ax.anchor, ay.anchor);
  return bilerp3(r0 + ax.i0 * c, r0 + ax.i1 * c, r1 + ax.i0 * c,
                 r1 + ax.i1 * c, ax.f, ay.f);
}

// calculate_shadow: 9 Poisson bilinear taps on the raw shadow map
__device__ float shadow_ref(const ShadeRefArgs& a, const FrameConsts& k, V3 p,
                            int* dbg) {
  const float* m = k.light_pv;
  float lp[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // [p, 1] @ light_pv.t(): the matrix product's multiply-add chain
    float acc = p.x * m[4 * r];
    acc = fmaf(p.y, m[4 * r + 1], acc);
    acc = fmaf(p.z, m[4 * r + 2], acc);
    lp[r] = fmaf(1.0f, m[4 * r + 3], acc);
  }
  const float wc = fabsf(lp[3]) > (float)1e-20 ? lp[3] : 1.0f;
  const float px = lp[0] / wc, py = lp[1] / wc, pz = lp[2] / wc;
  const float uvx = px * 0.5f + 0.5f;
  const float uvy = py * 0.5f + 0.5f;
  const bool beyond_far = pz > 1.0f;
  const float current = pz - (float)0.000005;
  const int s = a.shadow_size;
  float shadow = 0.0f;
  int bits = 0;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const Axis ax = axis(uvx + a.tap_off[t][0], s);
    const Axis ay = axis(uvy + a.tap_off[t][1], s);
    const float* r0 = a.shadow + ay.i0 * s;
    const float* r1 = a.shadow + ay.i1 * s;
    const float gx = 1.0f - ax.f;
    const float top = __ldg(r0 + ax.i0) * gx + __ldg(r0 + ax.i1) * ax.f;
    const float bot = __ldg(r1 + ax.i0) * gx + __ldg(r1 + ax.i1) * ax.f;
    const float closest = top * (1.0f - ay.f) + bot * ay.f;
    const bool lit_less = current > closest;
    shadow = shadow + (lit_less ? 1.0f : 0.0f);
    if (dbg != nullptr) {
      bits |= (lit_less ? 1 : 0) << t;
      dbg[kDbgTaps + t] = pack_anchor(ax.anchor, ay.anchor);
    }
  }
  if (dbg != nullptr) dbg[kDbgPcf] = bits | (beyond_far ? 1 << 9 : 0);
  shadow = shadow * (1.0f / 9.0f);
  const float result = (1.0f - shadow) * 0.75f + 0.25f;
  return beyond_far ? 1.0f : result;
}

__device__ __forceinline__ void store_clamped(const ShadeRefArgs& a, int y,
                                              int x, V3 col) {
  float* o = a.out + (y * a.w + x) * 3;
  o[0] = clampf(col.x, 0.0f, 1.0f);
  o[1] = clampf(col.y, 0.0f, 1.0f);
  o[2] = clampf(col.z, 0.0f, 1.0f);
}

__device__ void shade_ref_pixel(const ShadeRefArgs& a, const FrameConsts& k,
                                const float* lights, int y, int x) {
  int* dbg = a.dbg == nullptr ? nullptr : a.dbg + (y * a.w + x) * kDbgChannels;
  if (dbg != nullptr) {
    for (int i = 0; i < kDbgChannels; ++i) dbg[i] = -1;
  }
  const float depth =
      __ldg(a.depth + y * a.depth_strides[0] + x * a.depth_strides[1]);
  if (a.has_ibl && depth >= 1.0f) {
    // the skybox: the plain version's lights, shadow and ambient at this
    // pixel are discarded, so they are not evaluated; (i + 0.5) / n is a
    // multiply by the float reciprocal, as PyTorch divides by a scalar
    const float u = ((float)x + 0.5f) * (1.0f / (float)a.w);
    const float v = ((float)y + 0.5f) * (1.0f / (float)a.h);
    const FaceUV fc = cube_face_uv(sky_ray(k, u, v));
    int anchor;
    const V3 sky = sample_face(a.env, 0, a.env_size, a.env_c, fc, &anchor);
    if (dbg != nullptr) {
      dbg[kDbgFaces] = fc.face << 8;
      dbg[kDbgEnv] = anchor;
    }
    store_clamped(a, y, x, sky);
    return;
  }
  const V3 pos = plane3(a, 0, y, x);
  const V3 nrm = plane3(a, 1, y, x);
  const V3 base = plane3(a, 2, y, x);
  const V3 emis = plane3(a, 3, y, x);
  const V3 orm = plane3(a, 4, y, x);
  const float occlusion = orm.x, rough = orm.y, metallic = orm.z;
  const float ao =
      __ldg(a.ssao + y * a.ssao_strides[0] + x * a.ssao_strides[1]);
  const V3 eye = load3(k.eye);
  const V3 v = normalize_eps(sub(eye, pos));
  const V3 f0 = fresnel_f0(base, metallic);

  // shade_lights: summed in light order from zero
  V3 lo = v3(0.0f, 0.0f, 0.0f);
  for (int l = 0; l < a.n_lights; ++l) {
    lo = add(lo, surface_shading(pos, base, nrm, metallic, rough, v, f0,
                                 lights + l * kLightCols));
  }

  const float shadow =
      a.shadow != nullptr ? shadow_ref(a, k, pos, dbg) : 1.0f;

  V3 ambient = v3(0.0f, 0.0f, 0.0f);
  if (a.has_ibl) {  // ibl_ambient
    int a_irr, a_s0, a_s1, a_lut;
    const FaceUV fn = cube_face_uv(nrm);
    const V3 irr = sample_face(a.irr, 0, a.irr_size, a.irr_c, fn, &a_irr);
    const FaceUV fr = cube_face_uv(reflection_dir(pos, nrm, eye));
    // sample_mipcube_lod: trilinear between floor(lod) and the next level
    const int nl = a.num_levels;
    const float lod = clampf(rough * 7.0f, 0.0f, (float)(nl - 1));
    const int l0 = min(max((int)floorf(lod), 0), nl - 1);
    const int l1 = min(l0 + 1, nl - 1);
    const float f = lod - (float)l0;
    const V3 c0 = sample_face(a.spec, a.offsets[l0], a.sizes[l0], a.spec_c,
                              fr, &a_s0);
    const V3 c1 = sample_face(a.spec, a.offsets[l1], a.sizes[l1], a.spec_c,
                              fr, &a_s1);
    const V3 pref = add(scale(c0, 1.0f - f), scale(c1, f));
    // the BRDF LUT at (n.v, 1 - roughness), CLAMP_TO_EDGE
    const float ndotv = maxf(dot3(nrm, v), 0.0f);
    const Axis lx = axis(ndotv, a.lut_w), ly = axis(1.0f - rough, a.lut_h);
    const float* r0 = a.lut + ly.i0 * a.lut_w * a.lut_c;
    const float* r1 = a.lut + ly.i1 * a.lut_w * a.lut_c;
    const float* t00 = r0 + lx.i0 * a.lut_c;
    const float* t10 = r0 + lx.i1 * a.lut_c;
    const float* t01 = r1 + lx.i0 * a.lut_c;
    const float* t11 = r1 + lx.i1 * a.lut_c;
    const float gx = 1.0f - lx.f, gy = 1.0f - ly.f;
    float lut[2];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      const float top = __ldg(t00 + ch) * gx + __ldg(t10 + ch) * lx.f;
      const float bot = __ldg(t01 + ch) * gx + __ldg(t11 + ch) * lx.f;
      lut[ch] = top * gy + bot * ly.f;
    }
    a_lut = pack_anchor(lx.anchor, ly.anchor);
    ambient = split_sum(base, f0, ndotv, rough, metallic, occlusion, irr,
                        pref, lut[0], lut[1]);
    if (dbg != nullptr) {
      dbg[kDbgFaces] = fn.face | fr.face << 4;
      dbg[kDbgLevel] = l0;
      dbg[kDbgIrr] = a_irr;
      dbg[kDbgSpec0] = a_s0;
      dbg[kDbgSpec1] = a_s1;
      dbg[kDbgLut] = a_lut;
    }
  }
  store_clamped(a, y, x, combine_tonemap(ambient, lo, shadow, ao, emis));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    shade_ref_kernel(const ShadeRefArgs a) {
  __shared__ FrameConsts k;
  extern __shared__ float lights[];  // n_lights rows of kLightCols
  const int tid = threadIdx.y * kBlockW + threadIdx.x;
  load_lights(lights, a.lights, a.n_lights, a.light_stride, tid, kThreads);
  if (tid < 3) {
    k.eye[tid] = a.eye[tid];
    k.right[tid] = a.right[tid];
    k.up[tid] = a.up[tid];
    k.direction[tid] = a.direction[tid];
  }
  if (tid < 16) k.light_pv[tid] = a.light_pv[tid];
  if (tid < 2) k.near_wh[tid] = a.near_wh[tid];
  if (tid == 0) k.near_ = a.near_[0];
  __syncthreads();
  const int x = blockIdx.x * kBlockW + threadIdx.x;
  const int y = blockIdx.y * kBlockH + threadIdx.y;
  if (y < a.h && x < a.w) shade_ref_pixel(a, k, lights, y, x);
}

}  // namespace

// One launch over the (H, W) domain on ``stream``; returns
// cudaGetLastError() after it, or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int mo_shading_ref(const ShadeRefArgs* args, void* stream) {
  const size_t light_bytes =
      (size_t)args->n_lights * kLightCols * sizeof(float);
  if (light_bytes > (size_t)kMaxLightBytes ||
      (args->has_ibl &&
       (args->num_levels < 1 || args->num_levels > kMaxLevels))) {
    return (int)cudaErrorInvalidValue;
  }
  if (args->h > 0 && args->w > 0) {
    const dim3 grid((args->w + kBlockW - 1) / kBlockW,
                    (args->h + kBlockH - 1) / kBlockH);
    const dim3 block(kBlockW, kBlockH);
    shade_ref_kernel<<<grid, block, light_bytes, (cudaStream_t)stream>>>(
        *args);
  }
  return (int)cudaGetLastError();
}

// sizeof(ShadeRefArgs), for the wrapper's check of its ctypes layout
extern "C" int mo_shading_ref_args_size() { return (int)sizeof(ShadeRefArgs); }
