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
// and the IBL maps stay in the 50 MB L2) -- in practice the lit pixels'
// instructions: a lit pixel runs 9 PCF taps of 4 texels with their anchors
// and pinned blends, 4 bilinear IBL samples of 4 texels, ~10 correctly
// rounded divisions and roots and ~150 FP32 operations a light; a sky
// pixel its ray, its cube face and one bilinear sample.  Measured on the
// card (PERF.md section 6), the lit pixels take most of the time and the
// kernel stays under half of its byte bound.
//
// Design: a block of kWarps warps; each warp owns a span of kSpan
// consecutive pixels of the frame (row-major), with the frame's constants
// (light rows, light_pv, eye, camera basis, the specular level tables) in
// shared memory, loaded once a block.  A light table of more than
// kLightChunkRows rows (the kStreamed instance) streams through the same
// shared memory a chunk at a time in each round of the lit pass, every
// thread of the block taking part in each chunk's load (shade_lights),
// and the lit pixel takes that sum.
// 1. Each lane reads its span pixels' depths, all in flight at once.
// 2. Classify and compact: with IBL a pixel at depth >= 1 is sky (the
//    plain version computes its lights, shadow and ambient and then
//    discards them: where(depth >= 1, sky, ...)); the span's sky pixels and
//    its other ("lit") pixels go into two lists in shared memory, in pixel
//    order, through __ballot_sync / __popc prefix sums -- no atomics, and
//    nothing in device memory.
// 3. The sky pass, then 4. the lit pass: lane i of the warp shades the
//    list's pixels i, i + 32, ..., so every round of either pass is a full
//    warp but the list's last.  A warp that straddles a silhouette no
//    longer runs the lit path with only its lit lanes active.  A lit
//    pixel computes its 9 PCF tap anchors and issues their 36 loads before
//    any blend, and likewise the anchors and 44 texels of its irradiance,
//    two specular levels and LUT before their blends.
// Each pixel's colour is stored where it lies: a warp's stores of a list
// round cover its consecutive pixels.  The span, the block and the
// register cap (64 a thread: __launch_bounds__, kMinBlocks) were chosen by
// timing the alternatives on the card, as was leaving out what did not pay
// (PERF.md section 6: colour staged in shared memory for 16-byte stores,
// an L2 prefetch of the lit pixels' planes, a span of a whole block, the
// PCF texels held across the lights).  The G-buffer planes, depth and SSAO
// are read where they are, through their strides (32-bit offsets: the
// wrapper checks every extent).  Nothing is read on the host and nothing
// is allocated here, so a CUDA graph captures the launch.  A debug output
// (null on the frame's path) keeps each pixel's discrete choices -- PCF
// compares and tap texels, cube faces, mip level, texel anchors -- for a
// check against the plain version's.
//
// Arithmetic: this unit builds with -fmad=true -prec-div=false
// -prec-sqrt=false, as csrc/shading.cu does (kernels/_build.py
// UNIT_FLAGS): the lights, the split sum, the continuous samples' blends,
// the combine and the tonemap contract multiply-adds and divide and take
// roots to within 2 ulps, inside the pass's bar; the spot cone's power is
// __powf and pow5 a chain of products.  Every value that feeds a discrete
// choice is computed with the pinned helpers (__fmul_rn & co., never
// contracted, always correctly rounded), so it rounds once per operation
// as the plain version's torch op does on the card:
// - every texel anchor floor(t * n - 0.5) and its fraction (axis): the
//   PCF taps, the cube samples, the specular levels, the LUT, the sky;
// - the light projection's divide and * 0.5 + 0.5, each tap's uv + offset,
//   the compare's `current` and each tap's bilinear `closest` -- the pass's
//   hard discontinuity, current > closest;
// - with IBL the view vector V = normalize(eye - pos), n.v, 1 - roughness,
//   the reflection direction and the mip level floor(clamp(roughness * 7));
//   the sky rays (sky_dir) and cube_face_uv (shared with csrc/shading.cu)
//   are pinned throughout, and a sky ray's (i + 0.5) / n is a multiply by
//   the correctly rounded reciprocal, as PyTorch's CUDA division by a
//   scalar is.
// A dot product that feeds a choice (V's length, n.v, the reflection, the
// sky ray's length) adds its three products as PyTorch's CUDA sum(-1) over
// a 3-channel plane does, two threads an output: (x + z) + y (pdot3,
// shared with csrc/shading.cu).  Where the plain version's order is a
// library's, the kernel takes the card's: the light projection [wp, 1] @
// light_pv.T (cuBLAS) is a multiply-add chain in k order, and each PCF tap
// offset is the Python double dx / size rounded to float (the wrapper's
// tap_off).
// Sampling follows device/sampling.py: sample_cubemap and sample_bilinear
// clamp the texel indices, not the fractions.
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

// A warp owns a span of kSpan consecutive pixels (row-major) and lists
// them as uint8 indices; a block is kWarps warps; kMinBlocks blocks an SM
// cap a thread at 64 registers.
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSpan = 64;
constexpr int kSub = kSpan / 32;  // the span's rows of a warp's width
constexpr int kMinBlocks = 8;
constexpr int kTaps = 9;  // the Poisson PCF taps

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

// One bilinear axis of sample_cubemap / sample_bilinear, pinned: the
// anchor floor(t * n - 0.5), its fraction, and the two indices clamped to
// the edge (the fraction is not).
struct Axis {
  int i0, i1, anchor;
  float f;
};
__device__ __forceinline__ Axis axis(float t, int n) {
  const float x = psub(pmul(t, (float)n), 0.5f);
  const float x0 = floorf(x);
  Axis r;
  r.f = psub(x, x0);
  r.anchor = (int)x0;
  r.i0 = min(max(r.anchor, 0), n - 1);
  r.i1 = min(max(r.anchor + 1, 0), n - 1);
  return r;
}

// A bilinear sample's four texels (rows of a table: (y0, x0), (y0, x1),
// (y1, x0), (y1, x1)), its fractions and its packed anchor.
struct Quad {
  int row[4];
  float fx, fy;
  int anchor;
};
__device__ __forceinline__ Quad quad(const Axis& ax, const Axis& ay, int base,
                                     int n) {
  Quad q;
  q.row[0] = base + ay.i0 * n + ax.i0;
  q.row[1] = base + ay.i0 * n + ax.i1;
  q.row[2] = base + ay.i1 * n + ax.i0;
  q.row[3] = base + ay.i1 * n + ax.i1;
  q.fx = ax.f;
  q.fy = ay.f;
  q.anchor = pack_anchor(ax.anchor, ay.anchor);
  return q;
}
// sample_cubemap on the s x s faces from row ``off`` of a flat table (the
// specular chain's level: _sample_mipcube_level)
__device__ __forceinline__ Quad face_quad(int off, int s, FaceUV fc) {
  return quad(axis(fc.u, s), axis(fc.v, s), off + fc.face * s * s, s);
}

// the first ``C`` channels of a quad's texels, rows of ``c`` floats
template <int C>
__device__ __forceinline__ void fetch(const float* data, int c, const Quad& q,
                                      float v[4 * C]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      v[C * i + ch] = __ldg(data + q.row[i] * c + ch);
    }
  }
}

// _bilerp of channel ``ch`` of fetched texels (continuous: contracted)
template <int C>
__device__ __forceinline__ float bilerp(const float v[4 * C], int ch, float fx,
                                        float fy) {
  const float top = v[ch] * (1.0f - fx) + v[C + ch] * fx;
  const float bot = v[2 * C + ch] * (1.0f - fx) + v[3 * C + ch] * fx;
  return top * (1.0f - fy) + bot * fy;
}
__device__ __forceinline__ V3 bilerp3(const float v[12], const Quad& q) {
  return v3(bilerp<3>(v, 0, q.fx, q.fy), bilerp<3>(v, 1, q.fx, q.fy),
            bilerp<3>(v, 2, q.fx, q.fy));
}

// calculate_shadow: the light projection, the 9 Poisson taps' anchors and
// their 36 texels, then each tap's bilinear depth against the compare
// (pinned throughout)
__device__ __forceinline__ float shadow_ref(const ShadeRefArgs& a,
                                            const FrameConsts& k, V3 p,
                                            int* dbg) {
  const float* m = k.light_pv;
  float lp[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // [p, 1] @ light_pv.t(): the matrix product's multiply-add chain
    float acc = pmul(p.x, m[4 * r]);
    acc = fmaf(p.y, m[4 * r + 1], acc);
    acc = fmaf(p.z, m[4 * r + 2], acc);
    lp[r] = fmaf(1.0f, m[4 * r + 3], acc);
  }
  const float wc = fabsf(lp[3]) > (float)1e-20 ? lp[3] : 1.0f;
  const float px = pdiv(lp[0], wc), py = pdiv(lp[1], wc),
              pz = pdiv(lp[2], wc);
  const float uvx = padd(pmul(px, 0.5f), 0.5f);
  const float uvy = padd(pmul(py, 0.5f), 0.5f);
  const bool beyond_far = pz > 1.0f;
  const float current = psub(pz, (float)0.000005);
  const int s = a.shadow_size;
  Quad q[kTaps];
  float texel[kTaps][4];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    q[t] = quad(axis(padd(uvx, a.tap_off[t][0]), s),
                axis(padd(uvy, a.tap_off[t][1]), s), 0, s);
  }
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) texel[t][i] = __ldg(a.shadow + q[t].row[i]);
  }
  float shadow = 0.0f;
  int bits = 0;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const float fx = q[t].fx, fy = q[t].fy;
    const float gx = psub(1.0f, fx);
    const float top = padd(pmul(texel[t][0], gx), pmul(texel[t][1], fx));
    const float bot = padd(pmul(texel[t][2], gx), pmul(texel[t][3], fx));
    const float closest = padd(pmul(top, psub(1.0f, fy)), pmul(bot, fy));
    const bool lit_less = current > closest;
    shadow = shadow + (lit_less ? 1.0f : 0.0f);
    bits |= (lit_less ? 1 : 0) << t;
  }
  if (dbg != nullptr) {
#pragma unroll
    for (int t = 0; t < kTaps; ++t) dbg[kDbgTaps + t] = q[t].anchor;
    dbg[kDbgPcf] = bits | (beyond_far ? 1 << 9 : 0);
  }
  shadow = shadow * (1.0f / 9.0f);
  const float result = (1.0f - shadow) * 0.75f + 0.25f;
  return beyond_far ? 1.0f : result;
}

// ibl_ambient: the irradiance cube at the normal, the trilinear specular
// chain along the reflection, the BRDF LUT at (n.v, 1 - roughness) and the
// split sum; v = normalize(eye - pos) (pnormalize_eps)
__device__ __forceinline__ V3 ibl_ref(const ShadeRefArgs& a,
                                      const FrameConsts& k, V3 nrm, V3 v,
                                      V3 base, V3 f0, float rough,
                                      float metallic, float occlusion,
                                      int* dbg) {
  const float ndotv = pdot3(nrm, v);
  const FaceUV fn = cube_face_uv(nrm);
  // ibl_reflection_dir: reflect(V, N) = V - 2 dot(N, V) N
  const FaceUV fr = cube_face_uv(psub3(v, pscale3(nrm, pmul(2.0f, ndotv))));
  // sample_mipcube_lod: trilinear between floor(lod) and the next level
  const int nl = a.num_levels;
  const float lod = clampf(pmul(rough, 7.0f), 0.0f, (float)(nl - 1));
  const int l0 = min(max((int)floorf(lod), 0), nl - 1);
  const int l1 = min(l0 + 1, nl - 1);
  // the anchors, then every texel, then the blends
  const Quad qi = face_quad(0, a.irr_size, fn);
  const Quad q0 = face_quad(k.offsets[l0], k.sizes[l0], fr);
  const Quad q1 = face_quad(k.offsets[l1], k.sizes[l1], fr);
  const Quad ql = quad(axis(maxf(ndotv, 0.0f), a.lut_w),
                       axis(psub(1.0f, rough), a.lut_h), 0,
                       a.lut_w);  // CLAMP_TO_EDGE
  float ti[12], t0[12], t1[12], tl[8];
  fetch<3>(a.irr, a.irr_c, qi, ti);
  fetch<3>(a.spec, a.spec_c, q0, t0);
  fetch<3>(a.spec, a.spec_c, q1, t1);
  fetch<2>(a.lut, a.lut_c, ql, tl);
  if (dbg != nullptr) {
    dbg[kDbgFaces] = fn.face | fr.face << 4;
    dbg[kDbgLevel] = l0;
    dbg[kDbgIrr] = qi.anchor;
    dbg[kDbgSpec0] = q0.anchor;
    dbg[kDbgSpec1] = q1.anchor;
    dbg[kDbgLut] = ql.anchor;
  }
  const V3 irr = bilerp3(ti, qi);
  const float f = lod - (float)l0;
  const V3 pref =
      add(scale(bilerp3(t0, q0), 1.0f - f), scale(bilerp3(t1, q1), f));
  return split_sum(base, f0, maxf(ndotv, 0.0f), rough, metallic, occlusion,
                   irr, pref, bilerp<2>(tl, 0, ql.fx, ql.fy),
                   bilerp<2>(tl, 1, ql.fx, ql.fy));
}

__device__ __forceinline__ V3 clamp3(V3 c) {
  return v3(clampf(c.x, 0.0f, 1.0f), clampf(c.y, 0.0f, 1.0f),
            clampf(c.z, 0.0f, 1.0f));
}

// The G-buffer of lit pixel (y, x) that the lights read, V and F0, as
// shade_lit computes them (a streamed table's lights sum before it).
__device__ __forceinline__ Surface lit_surface(const ShadeRefArgs& a,
                                               const FrameConsts& k, int y,
                                               int x) {
  Surface s;
  s.pos = plane3(a, 0, y, x);
  s.n = plane3(a, 1, y, x);
  s.base = plane3(a, 2, y, x);
  const V3 orm = plane3(a, 4, y, x);
  s.rough = orm.y;
  s.metallic = orm.z;
  const V3 to_eye = psub3(load3(k.eye), s.pos);
  if (a.has_ibl) {
    s.v = pnormalize_eps(to_eye);
  } else {
    s.v = normalize_eps(to_eye);
  }
  s.f0 = fresnel_f0(s.base, s.metallic);
  return s;
}

// A lit pixel (not sky): shadow, lights, ambient, combine, tonemap, clamp.
// kStreamed: its lights' sum is ``streamed`` (shade_lights); otherwise the
// whole light table is in ``lights``.
template <bool kStreamed>
__device__ __forceinline__ V3 shade_lit(const ShadeRefArgs& a,
                                        const FrameConsts& k,
                                        const float* lights, int y, int x,
                                        int* dbg, V3 streamed) {
  const V3 pos = plane3(a, 0, y, x);
  const V3 nrm = plane3(a, 1, y, x);
  const V3 base = plane3(a, 2, y, x);
  const V3 emis = plane3(a, 3, y, x);
  const V3 orm = plane3(a, 4, y, x);
  const float occlusion = orm.x, rough = orm.y, metallic = orm.z;
  const float ao =
      __ldg(a.ssao + y * a.ssao_strides[0] + x * a.ssao_strides[1]);
  const float shadow =
      a.shadow != nullptr ? shadow_ref(a, k, pos, dbg) : 1.0f;
  // V: pinned where it feeds the LUT's anchor and the reflection
  const V3 to_eye = psub3(load3(k.eye), pos);
  V3 v;
  if (a.has_ibl) {
    v = pnormalize_eps(to_eye);
  } else {
    v = normalize_eps(to_eye);
  }
  const V3 f0 = fresnel_f0(base, metallic);
  // shade_lights: summed in light order from zero
  V3 lo = v3(0.0f, 0.0f, 0.0f);
  if constexpr (kStreamed) {
    lo = streamed;
  } else {
    for (int l = 0; l < a.n_lights; ++l) {
      lo = add(lo, surface_shading(pos, base, nrm, metallic, rough, v, f0,
                                   lights + l * kLightCols));
    }
  }
  const V3 ambient =
      a.has_ibl ? ibl_ref(a, k, nrm, v, base, f0, rough, metallic, occlusion,
                          dbg)
                : v3(0.0f, 0.0f, 0.0f);
  return clamp3(combine_tonemap(ambient, lo, shadow, ao, emis));
}

// The sky rays' terms that do not change over the frame (_sky_dirs):
// 1 / width and 1 / height (PyTorch divides by a scalar as a multiply by
// its float reciprocal), the near plane's half extents, near * direction.
struct SkyConsts {
  float inv_w, inv_h, hw, hh;
  V3 nd;
};
__device__ __forceinline__ SkyConsts sky_consts(const ShadeRefArgs& a,
                                                const FrameConsts& k) {
  SkyConsts c;
  c.inv_w = pdiv(1.0f, (float)a.w);
  c.inv_h = pdiv(1.0f, (float)a.h);
  c.hw = pdiv(k.near_wh[0], 2.0f);
  c.hh = pdiv(k.near_wh[1], 2.0f);
  c.nd = pscale3(load3(k.direction), k.near_);
  return c;
}

// _sky_dirs at pixel (y, x): the ray through ((x + 0.5) / w, (y + 0.5) / h)
// on the near plane, normalized (pinned)
__device__ __forceinline__ V3 sky_dir(const FrameConsts& k,
                                      const SkyConsts& c, int y, int x) {
  const float u = pmul(padd((float)x, 0.5f), c.inv_w);
  const float v = pmul(padd((float)y, 0.5f), c.inv_h);
  const float sx = psub(pmul(u, 2.0f), 1.0f);
  const float sy = psub(pmul(v, 2.0f), 1.0f);
  const V3 d = psub3(padd3(pscale3(load3(k.right), pmul(sx, c.hw)),
                           pscale3(load3(k.up), pmul(sy, c.hh))),
                     c.nd);
  const float inv =
      pdiv(1.0f, __fsqrt_rn(maxf(pdot3(d, d), (float)1e-20)));
  return pscale3(d, inv);
}

// A sky pixel: the environment along its ray.
__device__ __forceinline__ V3 shade_sky(const ShadeRefArgs& a,
                                        const FrameConsts& k,
                                        const SkyConsts& c, int y, int x,
                                        int* dbg) {
  const FaceUV fc = cube_face_uv(sky_dir(k, c, y, x));
  const Quad q = face_quad(0, a.env_size, fc);
  float t[12];
  fetch<3>(a.env, a.env_c, q, t);
  if (dbg != nullptr) {
    dbg[kDbgFaces] = fc.face << 8;
    dbg[kDbgEnv] = q.anchor;
  }
  return clamp3(bilerp3(t, q));
}

__device__ __forceinline__ int* dbg_of(const ShadeRefArgs& a, int p) {
  return a.dbg == nullptr ? nullptr : a.dbg + p * kDbgChannels;
}

// (y, x) of the pixel ``q`` past the span's first, (y0, x0)
__device__ __forceinline__ void pixel_of(const ShadeRefArgs& a, int y0, int x0,
                                         int q, int& y, int& x) {
  y = y0;
  for (x = x0 + q; x >= a.w; x -= a.w) ++y;
}

__device__ __forceinline__ void store3(const ShadeRefArgs& a, int p, V3 c) {
  float* o = a.out + 3 * p;
  o[0] = c.x;
  o[1] = c.y;
  o[2] = c.z;
}

// kStreamed: a light table of more than kLightChunkRows rows, which
// streams through the shared memory a chunk at a time in the lit pass;
// otherwise the table is loaded whole with the frame's constants.
template <bool kStreamed>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    shade_ref_kernel(const ShadeRefArgs a) {
  __shared__ FrameConsts k;
  __shared__ uint8_t sky_list[kWarps][kSpan], lit_list[kWarps][kSpan];
  extern __shared__ float lights[];  // the light rows, or a chunk of them
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  if (!kStreamed) {
    load_lights(lights, a.lights, a.n_lights, a.light_stride, t, kThreads);
  }
  if (t < 3) {
    k.eye[t] = a.eye[t];
    k.right[t] = a.right[t];
    k.up[t] = a.up[t];
    k.direction[t] = a.direction[t];
  }
  if (t < 16) k.light_pv[t] = a.light_pv[t];
  if (t < 2) k.near_wh[t] = a.near_wh[t];
  if (t == 0) k.near_ = a.near_[0];
  if (a.has_ibl && t < a.num_levels) {
    k.sizes[t] = a.sizes[t];
    k.offsets[t] = a.offsets[t];
  }

  // 1. the warp's span: every depth in flight at once
  const int n = a.h * a.w;
  const int p0 = (blockIdx.x * kWarps + warp) * kSpan;
  const int y0 = p0 / a.w, x0 = p0 - y0 * a.w;
  float depth[kSub];
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const int q = 32 * j + lane;
    int y, x;
    pixel_of(a, y0, x0, q, y, x);
    depth[j] = p0 + q < n ? __ldg(a.depth + y * a.depth_strides[0] +
                                  x * a.depth_strides[1])
                          : 0.0f;
    int* dbg = p0 + q < n ? dbg_of(a, p0 + q) : nullptr;
    if (dbg != nullptr) {
      for (int i = 0; i < kDbgChannels; ++i) dbg[i] = -1;
    }
  }
  // 2. classify (with IBL depth >= 1 is sky) and list the span's sky and
  // lit pixels, each in pixel order
  int n_sky = 0, n_lit = 0;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const int q = 32 * j + lane;
    const bool in = p0 + q < n;
    const bool sky = in && a.has_ibl && depth[j] >= 1.0f;
    const bool lit = in && !sky;
    const unsigned bs = __ballot_sync(0xFFFFFFFFu, sky);
    const unsigned bl = __ballot_sync(0xFFFFFFFFu, lit);
    if (sky) sky_list[warp][n_sky + __popc(bs & below)] = q;
    if (lit) lit_list[warp][n_lit + __popc(bl & below)] = q;
    n_sky += __popc(bs);
    n_lit += __popc(bl);
  }
  __syncthreads();  // the frame's constants, the lists

  // 3. the sky pass, then 4. the lit pass: full warps from the lists,
  // each pixel's colour stored where it lies
  if (n_sky > 0) {
    const SkyConsts c = sky_consts(a, k);
    for (int i = lane; i < n_sky; i += 32) {
      const int q = sky_list[warp][i];
      int y, x;
      pixel_of(a, y0, x0, q, y, x);
      store3(a, p0 + q, shade_sky(a, k, c, y, x, dbg_of(a, p0 + q)));
    }
  }
  if constexpr (kStreamed) {
    // kSub rounds, lane i taking the list's pixels i, i + 32, ...: every
    // thread runs every round, since the light table's chunks are the
    // block's to load (shade_lights)
    for (int r = 0; r < kSub; ++r) {
      const int i = lane + 32 * r;
      const bool lit = i < n_lit;
      const int q = lit ? lit_list[warp][i] : 0;
      int y, x;
      pixel_of(a, y0, x0, q, y, x);
      Surface s = {};
      if (lit) s = lit_surface(a, k, y, x);
      const V3 lo = shade_lights<kThreads>(lights, a.lights, a.n_lights,
                                           a.light_stride, t, lit, s);
      if (lit) {
        store3(a, p0 + q,
               shade_lit<true>(a, k, lights, y, x, dbg_of(a, p0 + q), lo));
      }
    }
  } else {
    for (int i = lane; i < n_lit; i += 32) {
      const int q = lit_list[warp][i];
      int y, x;
      pixel_of(a, y0, x0, q, y, x);
      store3(a, p0 + q, shade_lit<false>(a, k, lights, y, x,
                                         dbg_of(a, p0 + q),
                                         v3(0.0f, 0.0f, 0.0f)));
    }
  }
}

}  // namespace

// One launch over the (H, W) domain on ``stream``; returns
// cudaGetLastError() after it, or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int mo_shading_ref(const ShadeRefArgs* args, void* stream) {
  if (args->has_ibl &&
      (args->num_levels < 1 || args->num_levels > kMaxLevels)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool streamed = args->n_lights > kLightChunkRows;
  const size_t light_bytes =
      (size_t)(streamed ? kLightChunkRows : args->n_lights) * kLightCols *
      sizeof(float);
  const int n = args->h * args->w;
  if (n > 0) {
    const int blocks = (n + kWarps * kSpan - 1) / (kWarps * kSpan);
    const cudaStream_t s = (cudaStream_t)stream;
    if (streamed) {
      shade_ref_kernel<true><<<blocks, kThreads, light_bytes, s>>>(*args);
    } else {
      shade_ref_kernel<false><<<blocks, kThreads, light_bytes, s>>>(*args);
    }
  }
  return (int)cudaGetLastError();
}

// sizeof(ShadeRefArgs), for the wrapper's check of its ctypes layout
extern "C" int mo_shading_ref_args_size() { return (int)sizeof(ShadeRefArgs); }
