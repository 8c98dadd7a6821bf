// The reference sampling path's G-buffer pass for the PyTorch port's
// frames: the full-mode visibility buffer (triangle ids and screen-space
// barycentrics), the per-vertex stage's outputs, the material table and
// the texture array in, the G-buffer's six planes and its mask out.
//
// Replaces mo_renderer_tpu/passes/gbuffer.py gbuffer_pass:71 -- K12.  The
// reference has no pallas_call here: XLA fuses the jnp code on the TPU.
// The port's plain version (passes/gbuffer.py, _gbuffer_ref_plain) is ~460
// PyTorch launches a 1080p frame, among them an (H, W, 48) gather of the
// material rows (~400 MB at 1088 x 1920, written and read back), eight
// three-corner interpolations through int64 indices and five slots of four
// bilinear taps; this kernel is all of it, in one launch.
//
// What bounds it on this card: bytes in principle.  Every pixel reads its
// triangle id and writes 17 floats and the mask byte (~73 B); a covered
// pixel also reads its two barycentrics, its triangle's index row, three
// vertex rows (~100 B each), its material row and 4 texels of each of the
// 5 slots -- mostly L2 hits, since neighbouring pixels share triangles,
// materials and texels.  In practice a covered pixel is a dependent chain
// of loads (id -> index row and mesh -> vertex rows and material row ->
// UVs -> texels) and ~1000 instructions, so on a view with no sky pixel
// (PERF.md section 6, `@lit`) the instructions and the warps resident to
// hide the chain set the pace, not the bytes: a register cap that admits
// more warps, and every instruction cut, moved the time there; an L2
// prefetch did not.
//
// Design: a block is a tile of kTileH rows of 32 pixels, one thread a
// pixel; each warp owns one row's 32 consecutive pixels, stages their
// outputs and stores them, so no barrier spans two warps.  The first
// design (one thread a pixel of a 128-pixel span, 64 registers, scalar
// loads through the strides, each output stored where it was computed,
// the REPEAT wrap as four integer remainders a slot) reached 38% of the
// byte bound on the sky-free view and 63% on the sky-heavy ones.  For the
// card, each choice timed with scripts/torch_ab_gbuffer_ref.py (PERF.md
// section 6):
// - Staged 16-byte stores.  A pixel writes each output into its warp's
//   stage in shared memory as soon as it is computed, so none stays live
//   to the end; after __syncwarp the warp stores its span of each plane
//   as 16-byte vectors.  Stored pixel by pixel, a warp's store of one
//   channel of an (H, W, 3) plane touched three 128-byte lines a third
//   each.  A span cut by the target's edge, or not 16-byte aligned, is
//   stored element by element.  The mask byte is stored where it lies: a
//   warp's 32 bytes are one sector.
// - 64 registers (__launch_bounds__ kThreads, kMinBlocks): 32 warps an SM,
//   in blocks of two warps (kTileH rows).
//   Uncapped, the kernel took 96 and lost to the first design on every
//   view; 56 or 48 spill and lose more.
// - Fewer instructions a covered pixel.  The REPEAT wrap takes one floor-
//   mod per axis, not two (x0 + 1 wraps as xa + 1 == S ? 0 : xa + 1), and a
//   power-of-two texture size takes it as a mask (a uniform branch; other
//   sizes the integer remainder); the texel indices stay in the array
//   through the clamped layer, not four clamps; a texel byte becomes a
//   float through a byte permute into 2^23's mantissa and one subtraction,
//   exact (the conversion unit runs at a quarter of the FP32 rate); UV set
//   1 is interpolated only where the material samples it; and when the
//   vertex, index and material tables lie dense (channels contiguous, the
//   rows of clip positions, UVs and materials aligned for 16- and 8-byte
//   loads: what the frame's tables are), the C entry launches the
//   instance whose loads take immediate offsets from one row pointer and
//   read a clip row, a UV pair and the material row's 20 columns as
//   vectors.  Any other strides launch the strided instance.
// - Approximate arithmetic where no choice depends on it: see below.
// - The normal map's four taps are read only where the mesh has tangents
//   (or the debug output wants the anchor): without them the plain version
//   samples and discards them.
// Timed and left out: 2-D tiles (16 x 8, 8 x 16), 128- and 256-thread
// blocks and 64 x 1 or 128 x 1 tiles (within 1% or slower), sharing a
// triangle's rows across a warp with __match_any_sync and __shfl_sync (a
// warp's loads of one address are one request already: 7-10% slower), an
// L2 prefetch of a later tile's ids and barycentrics (faster uncapped,
// 1-5% slower at 64 registers on the sky-heavy views), and a warp with no
// covered pixel storing zeros without its stage (within 1%).
//
// Each input is read where it lies, through its strides; index arithmetic
// is 32-bit (passes/gbuffer.py gbuffer_ref_args checks every extent);
// indices are clamped into their tables, in range by construction.  An
// uncovered pixel reads only its id and writes zeros, as _assemble does.
// The outputs keep their contiguous (H, W, 3) / (H, W, 2) layouts, which
// K11, SSAO, present, the RenderPasses and the row-sharded band assembly
// read.  Nothing is read on the host but the argument block, and nothing
// is allocated here, so a CUDA graph captures the launch.  A debug output
// (null on the frame's path) keeps each pixel's five flat texel anchors
// and the UV set each slot chose, for a check against the plain version's.
//
// Arithmetic: the unit builds with -fmad=false and IEEE division
// (kernels/_build.py), so each operation rounds once as its torch op does
// on the card, in the plain version's order: b2 = (1 - b0) - b1, q_i = b_i
// * inv_w, qs = (q0 + q1) + q2, the |qs| > 1e-20 guard, q_i / qs; each
// interpolation (a0 * bb0 + a1 * bb1) + a2 * bb2; the texel coordinate
// u * S - 0.5, its floor and fraction, REPEAT as a floor-mod (negative and
// past-1 UVs wrap as torch.remainder does); uint8 times the float 1/255;
// _bilerp's rows then columns for the base colour and the normal map; the
// factors, srgb_to_linear's 0.04045 branch, the rsqrt of _normalize and
// its clamp, has_tangent from corner 0.  So the discontinuities -- the
// guard, each texel anchor, the UV set (material value == 0), the sRGB
// branch, the normalize clamp -- follow the plain version exactly.  Three
// continuous results are approximate, within ~1e-6 of the
// plain version's against the pass's bar of rtol 2e-3 / atol 1e-4, and
// feed no choice here: srgb_to_linear's power is __powf (the full powf is
// ~50 instructions a channel), _ndc01's divisions for the velocity are
// __fdividef, and the emissive, occlusion and metallic-roughness blends
// are two fused lerps of the bytes, then 1/255.  Nothing else contracts:
// the choices' feeds are most of the arithmetic.
// Shared with K10: csrc/gbuffer_common.cuh.
#include "gbuffer_common.cuh"

// the per-vertex attributes the kernel interpolates (GbufRefArgs.attr)
constexpr int kAttrWorldPos = 0;   // (V, 3)
constexpr int kAttrNormal = 1;     // (V, 3)
constexpr int kAttrTangent = 2;    // (V, 3)
constexpr int kAttrBitangent = 3;  // (V, 3)
constexpr int kAttrClip = 4;       // (V, 4)
constexpr int kAttrPrevClip = 5;   // (V, 4)
constexpr int kAttrUv0 = 6;        // (V, 2)
constexpr int kAttrUv1 = 7;        // (V, 2)
constexpr int kAttrs = 8;
// the debug output's int32 channels per pixel (-1 where uncovered): each
// slot's flat texel anchor layer * S * S + y0 * S + x0 after the wrap,
// then the UV sets (bit k: slot k sampled UV set 1)
constexpr int kDbgUvSets = 5;
constexpr int kDbgChannels = 6;
// material table columns (assets/materials.py MAT_*)
constexpr int kMatMap = 0;       // the five slots' texture layers
constexpr int kMatUv = 5;        // the five slots' UV sets
constexpr int kMatBaseFactor = 10;
constexpr int kMatEmissiveFactor = 14;
constexpr int kMatMetallic = 18;
constexpr int kMatRoughness = 19;
constexpr int kMatCols = 20;  // the columns read: 0 .. kMatRoughness

// What the kernel reads, filled by passes/gbuffer.py gbuffer_ref_args (its
// GbufRefArgs ctypes structure mirrors this one field for field).  Strides
// are in elements.
struct GbufRefArgs {
  const int* tri;  // (H, W) visibility ids, -1 uncovered
  int tri_st[2];
  const float* b0;  // (H, W) screen-space barycentrics
  int b0_st[2];
  const float* b1;
  int b1_st[2];
  const int* indices;  // (T, 3) vertex indices
  int indices_st[2];
  int n_tris;
  const float* inv_w;  // (V,) 1 / clip.w
  int inv_w_st;
  const float* attr[kAttrs];  // (V, k) per-vertex attributes
  int attr_st[kAttrs][2];
  int n_verts;
  const uint8_t* has_tangent;  // (V,) torch.bool
  int has_tangent_st;
  const int* tri_mesh;  // (T,) mesh of each triangle
  int tri_mesh_st;
  const int* mesh_material;  // (meshes,) material row of each mesh
  int mesh_material_st;
  int n_meshes;
  const float* materials;  // (rows, MATERIAL_STRIDE) material table
  int mat_st[2];
  int n_materials;
  const unsigned* textures;  // (L, S, S) RGBA8 texels, contiguous
  int n_texels;              // L * S * S
  int tex_size;              // S
  float inv255;
  int h, w;
  float* out[6];  // base colour, position, normal, emissive, orm (H, W, 3);
                  // velocity (H, W, 2); contiguous
  uint8_t* mask;  // (H, W) torch.bool
  int* dbg;       // (H, W, kDbgChannels) contiguous, or null
};

namespace {

// A block is a tile of kTileH rows of 32 pixels, one thread a pixel; warp
// r owns row r's 32 consecutive pixels.
constexpr int kTileH = 2;
constexpr int kThreads = 32 * kTileH;
constexpr int kMinBlocks = 16;  // __launch_bounds__: 64 registers a thread
// a pixel's outputs in its warp's stage: base colour, position, normal,
// emissive, orm (out[0..4], 3 floats a pixel), velocity (out[5], 2)
constexpr int kPlanes3 = 5;
constexpr int kOut = 3 * kPlanes3 + 2;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// torch.remainder(i, s) for s > 0: the floor-mod; a mask when s is a power
// of two (two's complement: i & (s - 1) is the floor-mod of any int)
__device__ __forceinline__ int wrap_repeat(int i, int s, bool pow2) {
  if (pow2) return i & (s - 1);
  const int r = i % s;
  return r < 0 ? r + s : r;
}

// byte c of an RGBA8 word as a float, exactly: the byte permuted into the
// mantissa of 2^23 (0x4B000000), minus 2^23
__device__ __forceinline__ float byte_of(unsigned word, int c) {
  const unsigned sel = (unsigned)c | 0x7540u;  // byte c, then 0x00, 0x00, 0x4B
  return __uint_as_float(__byte_perm(word, 0x4B000000u, sel)) - 8388608.0f;
}

// The four taps of one slot's bilinear sample (device/sampling.py
// sample_array_bilinear, REPEAT) at the texel coordinate of (u, v).
struct Taps {
  unsigned t00, t10, t01, t11;  // RGBA8 words
  float fx, fy;
};

// A slot's texel coordinate, wrap and four taps.  The flat indices stay in
// the array through the layer (clamped into [0, L - 1]; the wrapped x and
// y are in [0, S - 1]), in range by construction; ``anchor`` is the plain
// version's unclamped layer * S * S + y0 * S + x0, for the debug output.
__device__ __forceinline__ Taps gather_taps(const GbufRefArgs& a, int layer,
                                            float u, float v, bool pow2,
                                            int* anchor) {
  const int s = a.tex_size;
  const float xs = u * (float)s - 0.5f;
  const float ys = v * (float)s - 0.5f;
  const float x0 = floorf(xs);
  const float y0 = floorf(ys);
  Taps t;
  t.fx = xs - x0;
  t.fy = ys - y0;
  const int xa = wrap_repeat((int)x0, s, pow2);
  const int ya = wrap_repeat((int)y0, s, pow2);
  const int xb = xa + 1 == s ? 0 : xa + 1;  // (x0 + 1) wrapped
  const int yb = ya + 1 == s ? 0 : ya + 1;
  const int ss = s * s;
  if (anchor != nullptr) *anchor = layer * ss + ya * s + xa;
  const unsigned* base =
      a.textures + min(max(layer, 0) * ss, a.n_texels - ss);
  const unsigned* row_a = base + ya * s;
  const unsigned* row_b = base + yb * s;
  t.t00 = __ldg(row_a + xa);
  t.t10 = __ldg(row_a + xb);
  t.t01 = __ldg(row_b + xa);
  t.t11 = __ldg(row_b + xb);
  return t;
}

// channel c of a slot's sample: _bilerp of the four unorm taps
__device__ __forceinline__ float bilerp(const Taps& t, int c, float inv255) {
  const float gx = 1.0f - t.fx;
  const float top =
      (byte_of(t.t00, c) * inv255) * gx + (byte_of(t.t10, c) * inv255) * t.fx;
  const float bot =
      (byte_of(t.t01, c) * inv255) * gx + (byte_of(t.t11, c) * inv255) * t.fx;
  return top * (1.0f - t.fy) + bot * t.fy;
}

// channel c of a slot's sample for an output no choice depends on
// (emissive, occlusion, metallic-roughness): the four bytes blended in two
// fused lerps, then 1/255 (within ~1e-7 of _bilerp)
__device__ __forceinline__ float blend(const Taps& t, int c, float inv255) {
  const float b00 = byte_of(t.t00, c), b01 = byte_of(t.t01, c);
  const float top = fmaf(byte_of(t.t10, c) - b00, t.fx, b00);
  const float bot = fmaf(byte_of(t.t11, c) - b01, t.fx, b01);
  return fmaf(bot - top, t.fy, top) * inv255;
}

// srgb_to_linear (gbuffer_common.cuh) with its power __powf: the branch at
// 0.04045 exact, the power within ~1e-6
__device__ __forceinline__ float srgb_linear(float s) {
  if (s < 0.04045f) return s * (1.0f / 12.92f);
  const float t = (s + 0.055f) * (1.0f / 1.055f);
  return __powf(t < 0.0f ? 0.0f : t, 2.4f);  // a NaN passes, as in torch
}

// _ndc01 (gbuffer_common.cuh ndc01_of) with its divisions __fdividef
__device__ __forceinline__ void ndc01(float cx, float cy, float cw,
                                      float* out) {
  const float wc = fabsf(cw) > (float)1e-20 ? cw : 1.0f;
  out[0] = (__fdividef(cx, wc) + 1.0f) * 0.5f;
  out[1] = 1.0f - (__fdividef(cy, wc) + 1.0f) * 0.5f;
}

// A vertex row of attribute k: channel c at row[c * step].  Dense tables
// (the C entry checks) step by 1, so the loads take immediate offsets.
template <bool kDense>
struct Row {
  const float* row;
  int step;
  __device__ __forceinline__ float operator[](int c) const {
    return __ldg(row + (kDense ? c : c * step));
  }
};

template <bool kDense>
__device__ __forceinline__ Row<kDense> vrow(const GbufRefArgs& a, int k,
                                            int v) {
  return {a.attr[k] + v * a.attr_st[k][0], a.attr_st[k][1]};
}

// channels 0, 1 and 3 of a clip row (x, y, w): one 16-byte load if dense
template <bool kDense>
__device__ __forceinline__ V3 clip_xyw(const GbufRefArgs& a, int k, int v) {
  const Row<kDense> r = vrow<kDense>(a, k, v);
  if constexpr (kDense) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(r.row));
    return v3(q.x, q.y, q.w);
  }
  return v3(r[0], r[1], r[3]);
}

// a UV pair: one 8-byte load if dense
template <bool kDense>
__device__ __forceinline__ float2 uv_at(const GbufRefArgs& a, int k, int v) {
  const Row<kDense> r = vrow<kDense>(a, k, v);
  if constexpr (kDense) {
    return __ldg(reinterpret_cast<const float2*>(r.row));
  }
  return make_float2(r[0], r[1]);
}

// (a0 * bb0 + a1 * bb1) + a2 * bb2: _interp of one channel
__device__ __forceinline__ float interp(float a0, float a1, float a2,
                                        const float* bb) {
  return (a0 * bb[0] + a1 * bb[1]) + a2 * bb[2];
}

template <bool kDense>
__device__ __forceinline__ V3 interp3(const GbufRefArgs& a, int k,
                                      const int* vi, const float* bb) {
  const Row<kDense> r0 = vrow<kDense>(a, k, vi[0]);
  const Row<kDense> r1 = vrow<kDense>(a, k, vi[1]);
  const Row<kDense> r2 = vrow<kDense>(a, k, vi[2]);
  return v3(interp(r0[0], r1[0], r2[0], bb), interp(r0[1], r1[1], r2[1], bb),
            interp(r0[2], r1[2], r2[2], bb));
}

// the material row's kMatCols columns: five 16-byte loads if dense
template <bool kDense>
__device__ __forceinline__ void material_row(const GbufRefArgs& a, int id,
                                             float* m) {
  const float* row = a.materials + id * a.mat_st[0];
  if constexpr (kDense) {
#pragma unroll
    for (int c = 0; c < kMatCols; c += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(row + c));
      m[c] = q.x;
      m[c + 1] = q.y;
      m[c + 2] = q.z;
      m[c + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < kMatCols; ++c) m[c] = __ldg(row + c * a.mat_st[1]);
  }
}

// Covered pixel (y, x) = p with triangle ``tri``: its 17 outputs into its
// warp's stage as each is computed, plane k's channel c at
// s3[3 * 32 * k + c] (velocity: s2[c]).
template <bool kDense>
__device__ __forceinline__ void gbuffer_ref_pixel(const GbufRefArgs& a, int p,
                                                  int y, int x, int tri,
                                                  float* s3, float* s2) {
  auto put3 = [&](int k, V3 v) {
    s3[3 * 32 * k] = v.x;
    s3[3 * 32 * k + 1] = v.y;
    s3[3 * 32 * k + 2] = v.z;
  };
  const int t = min(tri, a.n_tris - 1);
  int vi[3];
  {
    const int* row = a.indices + t * a.indices_st[0];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      vi[k] = clampi(__ldg(row + (kDense ? k : k * a.indices_st[1])), 0,
                     a.n_verts - 1);
    }
  }
  const int mesh =
      clampi(__ldg(a.tri_mesh + t * a.tri_mesh_st), 0, a.n_meshes - 1);

  // perspective correction: q_i = b_i / w_i; B_i = q_i / sum(q)
  const float b0 = __ldg(a.b0 + (y * a.b0_st[0] + x * a.b0_st[1]));
  const float b1 = __ldg(a.b1 + (y * a.b1_st[0] + x * a.b1_st[1]));
  const float b2 = (1.0f - b0) - b1;
  const float q0 = b0 * __ldg(a.inv_w + vi[0] * a.inv_w_st);
  const float q1 = b1 * __ldg(a.inv_w + vi[1] * a.inv_w_st);
  const float q2 = b2 * __ldg(a.inv_w + vi[2] * a.inv_w_st);
  float qs = (q0 + q1) + q2;
  qs = fabsf(qs) > (float)1e-20 ? qs : 1.0f;
  const float bb[3] = {q0 / qs, q1 / qs, q2 / qs};

  // the geometry, each output staged as soon as it is computed
  put3(1, interp3<kDense>(a, kAttrWorldPos, vi, bb));
  {  // velocity: _ndc01(clip) - _ndc01(prev_clip)
    const V3 c0 = clip_xyw<kDense>(a, kAttrClip, vi[0]);
    const V3 c1 = clip_xyw<kDense>(a, kAttrClip, vi[1]);
    const V3 c2 = clip_xyw<kDense>(a, kAttrClip, vi[2]);
    const V3 p0 = clip_xyw<kDense>(a, kAttrPrevClip, vi[0]);
    const V3 p1 = clip_xyw<kDense>(a, kAttrPrevClip, vi[1]);
    const V3 p2 = clip_xyw<kDense>(a, kAttrPrevClip, vi[2]);
    float cur[2], prev[2];
    ndc01(interp(c0.x, c1.x, c2.x, bb), interp(c0.y, c1.y, c2.y, bb),
          interp(c0.z, c1.z, c2.z, bb), cur);
    ndc01(interp(p0.x, p1.x, p2.x, bb), interp(p0.y, p1.y, p2.y, bb),
          interp(p0.z, p1.z, p2.z, bb), prev);
    s2[0] = cur[0] - prev[0];
    s2[1] = cur[1] - prev[1];
  }
  const V3 n_geo = normalize_rsqrt(interp3<kDense>(a, kAttrNormal, vi, bb));
  const bool tangent = __ldg(a.has_tangent + vi[0] * a.has_tangent_st) != 0;

  // the material row (tri_mesh -> mesh_material) and the two UV sets
  float m[kMatCols];
  material_row<kDense>(
      a,
      clampi(__ldg(a.mesh_material + mesh * a.mesh_material_st), 0,
             a.n_materials - 1),
      m);
  auto uv_set = [&](int k) -> float2 {
    const float2 c0 = uv_at<kDense>(a, k, vi[0]);
    const float2 c1 = uv_at<kDense>(a, k, vi[1]);
    const float2 c2 = uv_at<kDense>(a, k, vi[2]);
    return make_float2(interp(c0.x, c1.x, c2.x, bb),
                       interp(c0.y, c1.y, c2.y, bb));
  };
  // UV set 1 only where a slot of the material samples it (uniform per
  // material)
  bool any_set1 = false;
#pragma unroll
  for (int k = 0; k < 5; ++k) any_set1 |= !(m[kMatUv + k] == 0.0f);
  const float2 uv[2] = {uv_set(kAttrUv0),
                        any_set1 ? uv_set(kAttrUv1) : make_float2(0.0f, 0.0f)};

  // the five slots -- base colour, normal, metallic-roughness, occlusion,
  // emissive -- each with its UV set; the normal map's taps are read only
  // where the mesh has tangents (the plain version discards them else)
  const bool pow2 = (a.tex_size & (a.tex_size - 1)) == 0;
  int* d = a.dbg != nullptr ? a.dbg + p * kDbgChannels : nullptr;
  int uv_sets = 0;
  auto slot = [&](int k, bool fetch) -> Taps {
    const bool set1 = !(m[kMatUv + k] == 0.0f);
    const float2 st = set1 ? uv[1] : uv[0];
    uv_sets |= (set1 ? 1 : 0) << k;
    if (!fetch) {
      Taps none;
      none.t00 = none.t10 = none.t01 = none.t11 = 0u;
      none.fx = none.fy = 0.0f;
      return none;
    }
    return gather_taps(a, (int)m[kMatMap + k], st.x, st.y, pow2,
                       d != nullptr ? d + k : nullptr);
  };
  const Taps base = slot(0, true);
  const Taps nt = slot(1, tangent || d != nullptr);
  const Taps mr = slot(2, true);
  const Taps occ = slot(3, true);
  const Taps emi = slot(4, true);
  if (d != nullptr) d[kDbgUvSets] = uv_sets;

  put3(0, v3(srgb_linear(bilerp(base, 0, a.inv255) * m[kMatBaseFactor]),
             srgb_linear(bilerp(base, 1, a.inv255) * m[kMatBaseFactor + 1]),
             srgb_linear(bilerp(base, 2, a.inv255) * m[kMatBaseFactor + 2])));
  put3(3, v3(blend(emi, 0, a.inv255) * m[kMatEmissiveFactor],
             blend(emi, 1, a.inv255) * m[kMatEmissiveFactor + 1],
             blend(emi, 2, a.inv255) * m[kMatEmissiveFactor + 2]));
  put3(4, v3(blend(occ, 0, a.inv255),
             blend(mr, 1, a.inv255) * m[kMatRoughness],
             blend(mr, 2, a.inv255) * m[kMatMetallic]));

  // normal mapping (gbuffer.frag:55-60): TBN only when tangents exist,
  // has_tangent taken from corner 0 (uniform per mesh)
  V3 nrm = n_geo;
  if (tangent) {
    const V3 t_in = interp3<kDense>(a, kAttrTangent, vi, bb);
    const V3 bt_in = interp3<kDense>(a, kAttrBitangent, vi, bb);
    const V3 n_tex = normalize_rsqrt(v3(bilerp(nt, 0, a.inv255) * 2.0f - 1.0f,
                                        bilerp(nt, 1, a.inv255) * 2.0f - 1.0f,
                                        bilerp(nt, 2, a.inv255) * 2.0f - 1.0f));
    nrm = normalize_rsqrt(
        v3((t_in.x * n_tex.x + bt_in.x * n_tex.y) + n_geo.x * n_tex.z,
           (t_in.y * n_tex.x + bt_in.y * n_tex.y) + n_geo.y * n_tex.z,
           (t_in.z * n_tex.x + bt_in.z * n_tex.y) + n_geo.z * n_tex.z));
  }
  put3(2, nrm);
}

template <bool kDense>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gbuffer_ref_kernel(const GbufRefArgs a) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int y = blockIdx.y * kTileH + warp;
  const int xs = blockIdx.x * 32;  // the warp's span
  const int x = xs + lane;
  // each warp's stage: plane k's 32 x 3 floats, then the velocity's 32 x 2
  __shared__ __align__(16) float stage[kThreads / 32][kOut * 32];
  float* s3 = stage[warp] + 3 * lane;
  float* s2 = stage[warp] + 3 * 32 * kPlanes3 + 2 * lane;

  bool covered = false;
  if (x < a.w && y < a.h) {
    const int p = y * a.w + x;
    const int tri = __ldg(a.tri + (y * a.tri_st[0] + x * a.tri_st[1]));
    covered = tri >= 0;
    if (covered) {
      gbuffer_ref_pixel<kDense>(a, p, y, x, tri, s3, s2);
    } else if (a.dbg != nullptr) {
#pragma unroll
      for (int k = 0; k < kDbgChannels; ++k) a.dbg[p * kDbgChannels + k] = -1;
    }
    a.mask[p] = covered ? 1 : 0;  // a warp's 32 bytes: one sector
  }
  if (!covered) {  // _assemble's clear values
#pragma unroll
    for (int k = 0; k < kPlanes3; ++k) {
#pragma unroll
      for (int c = 0; c < 3; ++c) s3[3 * 32 * k + c] = 0.0f;
    }
    s2[0] = 0.0f;
    s2[1] = 0.0f;
  }
  __syncwarp();

  // The warp's span of each plane, width * cnt floats at
  // out[k] + width * (y * w + xs): lane j stores floats 4j .. 4j + 3, as
  // one 16-byte vector where the span is whole and 16-byte aligned, else
  // element by element.
  const int cnt = min(32, a.w - xs);
  if (y >= a.h || cnt <= 0) return;
  const int off = y * a.w + xs;
#pragma unroll
  for (int k = 0; k <= kPlanes3; ++k) {
    const int width = k < kPlanes3 ? 3 : 2;
    if (lane >= width * 8) continue;
    const float* src = stage[warp] + 3 * 32 * k + 4 * lane;
    float* dst = a.out[k] + width * off + 4 * lane;
    if (cnt == 32 && (reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
      const int n = min(4, width * cnt - 4 * lane);
      for (int e = 0; e < n; ++e) dst[e] = src[e];
    }
  }
}

// Whether the tables the dense instance reads with immediate offsets and
// vectors lie so: every attribute's, the index rows' and the material
// rows' channels contiguous; clip rows and material rows 16-byte aligned,
// UV rows 8-byte aligned.
bool dense_tables(const GbufRefArgs& a) {
  auto aligned = [](const void* p, int row_stride, int floats) {
    return reinterpret_cast<uintptr_t>(p) % (4u * floats) == 0 &&
           row_stride % floats == 0;
  };
  bool ok = a.indices_st[1] == 1 && a.mat_st[1] == 1 &&
            aligned(a.materials, a.mat_st[0], 4);
  for (int k = 0; k < kAttrs; ++k) {
    const int floats = k == kAttrClip || k == kAttrPrevClip ? 4
                       : k == kAttrUv0 || k == kAttrUv1     ? 2
                                                            : 1;
    ok = ok && a.attr_st[k][1] == 1 &&
         aligned(a.attr[k], a.attr_st[k][0], floats);
  }
  return ok;
}

}  // namespace

// One launch over the (H, W) target on ``stream``, a block a tile; returns
// cudaGetLastError() after it.
extern "C" int mo_gbuffer_ref(const GbufRefArgs* args, void* stream) {
  if (args->h > 0 && args->w > 0) {
    const dim3 grid((args->w + 31) / 32, (args->h + kTileH - 1) / kTileH);
    if (dense_tables(*args)) {
      gbuffer_ref_kernel<true>
          <<<grid, kThreads, 0, (cudaStream_t)stream>>>(*args);
    } else {
      gbuffer_ref_kernel<false>
          <<<grid, kThreads, 0, (cudaStream_t)stream>>>(*args);
    }
  }
  return (int)cudaGetLastError();
}

// sizeof(GbufRefArgs), for the wrapper's check of its ctypes layout
extern "C" int mo_gbuffer_ref_args_size() { return (int)sizeof(GbufRefArgs); }
