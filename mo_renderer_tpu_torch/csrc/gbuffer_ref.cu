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
// What bounds it on this card: bytes.  Every pixel reads its triangle id
// and writes 17 floats and the mask byte (~73 B); a covered pixel also
// reads its two barycentrics, its triangle's index row, three vertex rows
// (~100 B each: 1/w, position, normal, tangent, bitangent, two clip
// positions, two UV sets, has_tangent), its material row and 4 texels of
// each of the 5 slots -- mostly L2 hits, since neighbouring pixels share
// triangles, materials and texels.  Its ~420 FP32 operations a covered
// pixel are far below the card's compute rate.  In practice the loads are
// a dependent chain (id -> index row -> vertex rows -> UVs -> texels), so
// latency, not bandwidth, sets the time.
//
// Design: one thread a pixel of the (H, W) target, blocks of kThreads
// consecutive pixels of the row-major domain.  Each input is read where it
// lies, through its strides, once, with __ldg: the id and barycentric
// planes, the index row, the three vertex rows of each attribute, the
// material row (by tri_mesh and mesh_material); each slot's four taps are
// gathered once as 32-bit RGBA8 words (the texture array must be
// contiguous), whatever channels the slot uses.  No (H, W, 48) material
// tensor exists.  An uncovered pixel reads only its id and writes zeros,
// as _assemble does.  The outputs are written in place into their
// contiguous (H, W, 3) / (H, W, 2) planes, which K11, SSAO, present and
// the RenderPasses read.  Index arithmetic is 32-bit (passes/gbuffer.py
// gbuffer_ref_args checks every extent); indices are clamped into their
// tables, in range by construction.  Nothing is read on the host and
// nothing is allocated here, so a CUDA graph captures the launch.  A debug
// output (null on the frame's path) keeps each pixel's five flat texel
// anchors and the UV set each slot chose, for a check against the plain
// version's.
//
// Arithmetic: the unit builds with -fmad=false and IEEE division
// (kernels/_build.py), so each operation rounds once as its torch op does
// on the card, in the plain version's order: b2 = (1 - b0) - b1, q_i = b_i
// * inv_w, qs = (q0 + q1) + q2, the |qs| > 1e-20 guard, q_i / qs; each
// interpolation (a0 * bb0 + a1 * bb1) + a2 * bb2; the texel coordinate
// u * S - 0.5, its floor and fraction, REPEAT as a floor-mod (negative and
// past-1 UVs wrap as torch.remainder does); uint8 times the float 1/255;
// _bilerp's rows then columns; the factors, srgb_to_linear, the rsqrt of
// _normalize, has_tangent from corner 0, and _ndc01's division for the
// velocity.  So the discontinuities -- the guard, each texel anchor, the
// UV set (material value == 0) -- follow the plain version exactly.
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

constexpr int kThreads = 128;  // pixels a block

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// torch.remainder(i, n) for n > 0: the floor-mod
__device__ __forceinline__ int wrap_repeat(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// The four taps of one slot's bilinear sample (device/sampling.py
// sample_array_bilinear, REPEAT) at the texel coordinate of (u, v).
struct Taps {
  unsigned t00, t10, t01, t11;  // RGBA8 words
  float fx, fy;
  int anchor;  // flat index of the wrapped (x0, y0)
};

__device__ __forceinline__ Taps gather_taps(const GbufRefArgs& a, int layer,
                                            float u, float v) {
  const int s = a.tex_size;
  const float xs = u * (float)s - 0.5f;
  const float ys = v * (float)s - 0.5f;
  const float x0 = floorf(xs);
  const float y0 = floorf(ys);
  Taps t;
  t.fx = xs - x0;
  t.fy = ys - y0;
  const int x0i = (int)x0;
  const int y0i = (int)y0;
  const int xa = wrap_repeat(x0i, s), xb = wrap_repeat(x0i + 1, s);
  const int ya = wrap_repeat(y0i, s), yb = wrap_repeat(y0i + 1, s);
  const int base = layer * (s * s);
  const int last = a.n_texels - 1;
  t.anchor = base + ya * s + xa;
  t.t00 = __ldg(a.textures + clampi(t.anchor, 0, last));
  t.t10 = __ldg(a.textures + clampi(base + ya * s + xb, 0, last));
  t.t01 = __ldg(a.textures + clampi(base + yb * s + xa, 0, last));
  t.t11 = __ldg(a.textures + clampi(base + yb * s + xb, 0, last));
  return t;
}

// channel c of a slot's sample: _bilerp of the four unorm taps
__device__ __forceinline__ float bilerp(const Taps& t, int c, float inv255) {
  const unsigned s = 8u * (unsigned)c;
  const float top =
      unorm8(t.t00, s, inv255) * (1.0f - t.fx) + unorm8(t.t10, s, inv255) * t.fx;
  const float bot =
      unorm8(t.t01, s, inv255) * (1.0f - t.fx) + unorm8(t.t11, s, inv255) * t.fx;
  return top * (1.0f - t.fy) + bot * t.fy;
}

// Covered pixel (y, x) = p with triangle ``tri``: its 17 outputs into ``o``
// (base colour 0-2, position 3-5, normal 6-8, emissive 9-11, orm 12-14,
// velocity 15-16).
__device__ __forceinline__ void gbuffer_ref_pixel(const GbufRefArgs& a, int p,
                                                  int y, int x, int tri,
                                                  float* o) {
  const int t = min(tri, a.n_tris - 1);
  int vi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    vi[k] = clampi(
        __ldg(a.indices + (t * a.indices_st[0] + k * a.indices_st[1])), 0,
        a.n_verts - 1);
  }

  // perspective correction: q_i = b_i / w_i; B_i = q_i / sum(q)
  const float b0 = __ldg(a.b0 + (y * a.b0_st[0] + x * a.b0_st[1]));
  const float b1 = __ldg(a.b1 + (y * a.b1_st[0] + x * a.b1_st[1]));
  const float b2 = (1.0f - b0) - b1;
  const float q0 = b0 * __ldg(a.inv_w + vi[0] * a.inv_w_st);
  const float q1 = b1 * __ldg(a.inv_w + vi[1] * a.inv_w_st);
  const float q2 = b2 * __ldg(a.inv_w + vi[2] * a.inv_w_st);
  float qs = (q0 + q1) + q2;
  qs = fabsf(qs) > (float)1e-20 ? qs : 1.0f;
  const float bb0 = q0 / qs;
  const float bb1 = q1 / qs;
  const float bb2 = q2 / qs;

  // _interp: channel c of attribute k
  auto interp = [&](int k, int c) -> float {
    const float* col = a.attr[k] + c * a.attr_st[k][1];
    const int rs = a.attr_st[k][0];
    return (__ldg(col + vi[0] * rs) * bb0 + __ldg(col + vi[1] * rs) * bb1) +
           __ldg(col + vi[2] * rs) * bb2;
  };
  auto interp3 = [&](int k) -> V3 {
    return v3(interp(k, 0), interp(k, 1), interp(k, 2));
  };

  // the material row: tri_mesh -> mesh_material -> materials
  const int mesh = clampi(__ldg(a.tri_mesh + t * a.tri_mesh_st), 0,
                          a.n_meshes - 1);
  const int mat_id = clampi(
      __ldg(a.mesh_material + mesh * a.mesh_material_st), 0,
      a.n_materials - 1);
  const float* mat_row = a.materials + mat_id * a.mat_st[0];
  auto mat = [&](int c) -> float { return __ldg(mat_row + c * a.mat_st[1]); };

  const float u0 = interp(kAttrUv0, 0), v0 = interp(kAttrUv0, 1);
  const float u1 = interp(kAttrUv1, 0), v1 = interp(kAttrUv1, 1);

  // the five slots' taps, each gathered once: base colour, normal,
  // metallic-roughness, occlusion, emissive
  Taps taps[5];
  int uv_sets = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int layer = (int)mat(kMatMap + k);
    const bool set1 = !(mat(kMatUv + k) == 0.0f);
    uv_sets |= (set1 ? 1 : 0) << k;
    taps[k] = gather_taps(a, layer, set1 ? u1 : u0, set1 ? v1 : v0);
  }
  if (a.dbg != nullptr) {
    int* d = a.dbg + p * kDbgChannels;
#pragma unroll
    for (int k = 0; k < 5; ++k) d[k] = taps[k].anchor;
    d[kDbgUvSets] = uv_sets;
  }

#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = srgb_to_linear(bilerp(taps[0], c, a.inv255) *
                          mat(kMatBaseFactor + c));
    o[9 + c] = bilerp(taps[4], c, a.inv255) * mat(kMatEmissiveFactor + c);
  }
  o[12] = bilerp(taps[3], 0, a.inv255);
  o[13] = bilerp(taps[2], 1, a.inv255) * mat(kMatRoughness);
  o[14] = bilerp(taps[2], 2, a.inv255) * mat(kMatMetallic);

  const V3 wp = interp3(kAttrWorldPos);
  o[3] = wp.x;
  o[4] = wp.y;
  o[5] = wp.z;

  // normal mapping (gbuffer.frag:55-60): TBN only when tangents exist,
  // has_tangent taken from corner 0 (uniform per mesh)
  const V3 n_geo = normalize_rsqrt(interp3(kAttrNormal));
  V3 nrm = n_geo;
  if (__ldg(a.has_tangent + vi[0] * a.has_tangent_st) != 0) {
    const V3 t_in = interp3(kAttrTangent);
    const V3 bt_in = interp3(kAttrBitangent);
    const V3 n_tex = normalize_rsqrt(
        v3(bilerp(taps[1], 0, a.inv255) * 2.0f - 1.0f,
           bilerp(taps[1], 1, a.inv255) * 2.0f - 1.0f,
           bilerp(taps[1], 2, a.inv255) * 2.0f - 1.0f));
    nrm = normalize_rsqrt(
        v3((t_in.x * n_tex.x + bt_in.x * n_tex.y) + n_geo.x * n_tex.z,
           (t_in.y * n_tex.x + bt_in.y * n_tex.y) + n_geo.y * n_tex.z,
           (t_in.z * n_tex.x + bt_in.z * n_tex.y) + n_geo.z * n_tex.z));
  }
  o[6] = nrm.x;
  o[7] = nrm.y;
  o[8] = nrm.z;

  // velocity: _ndc01(clip) - _ndc01(prev_clip)
  float cur[2], prev[2];
  ndc01_of(interp(kAttrClip, 0), interp(kAttrClip, 1), interp(kAttrClip, 3),
           cur);
  ndc01_of(interp(kAttrPrevClip, 0), interp(kAttrPrevClip, 1),
           interp(kAttrPrevClip, 3), prev);
  o[15] = cur[0] - prev[0];
  o[16] = cur[1] - prev[1];
}

__global__ void __launch_bounds__(kThreads)
    gbuffer_ref_kernel(const GbufRefArgs a) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= a.h * a.w) return;
  const int y = p / a.w;
  const int x = p - y * a.w;
  const int tri = __ldg(a.tri + (y * a.tri_st[0] + x * a.tri_st[1]));
  float o[17];
#pragma unroll
  for (int i = 0; i < 17; ++i) o[i] = 0.0f;  // _assemble's clear values
  if (tri >= 0) {
    gbuffer_ref_pixel(a, p, y, x, tri, o);
  } else if (a.dbg != nullptr) {
#pragma unroll
    for (int k = 0; k < kDbgChannels; ++k) a.dbg[p * kDbgChannels + k] = -1;
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c) a.out[k][3 * p + c] = o[3 * k + c];
  }
  a.out[5][2 * p] = o[15];
  a.out[5][2 * p + 1] = o[16];
  a.mask[p] = tri >= 0 ? 1 : 0;
}

}  // namespace

// One launch over the (H, W) target on ``stream``; returns
// cudaGetLastError() after it.
extern "C" int mo_gbuffer_ref(const GbufRefArgs* args, void* stream) {
  const int n = args->h * args->w;
  if (n > 0) {
    gbuffer_ref_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

// sizeof(GbufRefArgs), for the wrapper's check of its ctypes layout
extern "C" int mo_gbuffer_ref_args_size() { return (int)sizeof(GbufRefArgs); }
