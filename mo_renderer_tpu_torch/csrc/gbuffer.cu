// The fast path's G-buffer tail for the PyTorch port's frames: attribute
// planes and material columns in, the G-buffer's six planes and its mask
// out.
//
// Replaces mo_renderer_tpu/passes/gbuffer.py _texture_and_assemble:361 and
// the velocity lines in front of it (gbuffer_pass_fast:219,
// gbuffer_pass_from_planes:518) -- K10.  The reference has no pallas_call
// here: XLA fuses the jnp code on the TPU.  The port's plain version
// (passes/gbuffer.py, _gbuffer_tail_plain, which runs _texture_and_assemble)
// is ~135 PyTorch ops a frame, each one pass over an (H, W, k) plane; this
// kernel is all of them.
//
// What bounds it on this card: bytes.  Per pixel it reads the visibility id,
// 15 attribute channels and the used material columns (11 to 31 floats), one
// 16-byte RGBA8 quad per sampled slot (mostly L2 hits: neighbouring pixels
// sample neighbouring texels), and writes 17 floats and the mask byte
// (~180 B a pixel, ~0.06 ms at the 1088 x 960 checkerboard domain); its
// ~200 FP32 operations a pixel are far below the card's compute rate.
//
// Design: one thread per pixel of the G-buffer domain, blocks of kThreads
// consecutive pixels of the row-major (H, W) domain.  Every input channel
// is a pointer with its row and column strides, so each caller's tensors are
// read where they are, with no copy of a view: the attr_planes kernel's
// (C, H, W) planes (wp 0-2, n 3-5, t 6-8, bt 9-11, uv0 12-13, handedness
// 15, material columns 16 and up), the (H, W, k) tensors of the
// attrs_plane_kernel=False branch, and the raster megakernel's 14 planes,
// whose material row is fetched here from scene.materials by the rounded
// (rintf: half to even, as torch.round) material-id plane.  The sampled
// slots' quads are gathered from the texture-stack groups, or read from the
// stack_planes kernel's planes on the stacks path.  An uncovered pixel reads
// nothing and writes zeros, as _assemble does.  Nothing is read on the host
// and nothing is allocated here, so a CUDA graph captures the launch.
//
// For the card (the first design stored each pixel's 17 floats where it
// computed them, reloaded inputs, and reached 37-49% of the byte bound):
// - Every input is read once into registers, through the read-only path
//   (__ldg): each gathered slot's 16-byte quad once (not once per channel),
//   each channel and material column once.  Index arithmetic is 32-bit
//   (passes/gbuffer.py tail_args checks every extent).
// - The outputs keep their contiguous (H, W, 3) and (H, W, 2) layouts, which
//   every consumer reads (K9 through strides, SSAO, present, the passes, the
//   row-sharded frame's band assembly, .view()s of the G-buffer): a block
//   stages its pixels' 17 floats and mask bytes in shared memory and then
//   stores the block's contiguous span of each plane as 16-byte vectors.
//   Stored pixel by pixel, a warp's store of one channel touched three
//   128-byte lines a third each; most of the domain is sky, whose zeros
//   were all the kernel wrote there.  A block past the domain's end stores
//   its span element by element.
// Timed on the card (PERF.md section 6): the single loads
// and 32-bit offsets took most of the time off; the staged stores at 128
// pixels a block gave the rest, a few percent over storing in place.
//
// (the helpers shared with K12, csrc/gbuffer_ref.cu)
#include "gbuffer_common.cuh"

// geometry channels: wp 0-2, n 3-5, t 6-8, bt 9-11, uv0 12-13, handedness 14
constexpr int kGeo = 15;
// material columns: materials.fast_used_cols is 11 + 4 per constant slot
constexpr int kMaxMat = 31;

// What the kernel reads, filled by passes/gbuffer.py tail_args (its
// GbufArgs ctypes structure mirrors this one field for field).
struct GbufArgs {
  const float* ch[kGeo + kMaxMat];  // per channel: its (H, W) plane
  int st[kGeo + kMaxMat][2];  // row and column strides, in elements
  const int* tri;                   // (H, W) visibility ids
  int tri_st[2];
  const float* mat_id;  // megakernel: (H, W) material ids, else null
  int mat_id_st[2];
  const float* materials;  // (rows, mat_stride) material table
  int mat_stride, n_materials;
  int mat_col[kMaxMat];  // megakernel: the table column of used column k
  const int* groups[3];  // texture-stack groups (rows, 4k) RGBA8 quads
  int group_words[3], group_rows[3];
  const float* sk;  // stacks path: the stack_planes kernel's (n, H, W)
  int slot_kind[5];  // 0 constant, 1 gathered quad, 2 stack_planes plane
  int slot_group[5], slot_word[5];
  int slot_plane[5][3];  // the stack_planes plane of channel c
  // positions in the used material columns (materials.fast_used_cols)
  int col_stack_base, col_stack_size, col_base_factor, col_emissive_factor;
  int col_metallic, col_roughness;
  int col_const[5];  // slot k's constant colour (constant slots)
  const float* pv;       // (4, 4) row-major
  const float* prev_pv;  // (4, 4) row-major
  float inv255;
  int ht_abs;  // has_tangent is |handedness| > 0.5 (else handedness > 0.5)
  int h, w;
  float* out[6];  // base colour, position, normal, emissive, orm (H, W, 3);
                  // velocity (H, W, 2); contiguous
  uint8_t* mask;  // (H, W) torch.bool
  // debug output, null on the frame's path: each covered pixel's stack row
  // (its bilinear anchor texel; -1 where nothing is gathered), so that a
  // check can count the texel indices that differ from the plain version's
  int* row_out;
};

namespace {

constexpr int kThreads = 128;  // pixels a block: the fastest of 128-512 timed
// a pixel's outputs in registers and in the stage: base colour 0-2,
// position 3-5, normal 6-8, emissive 9-11, orm 12-14 (out[0..4], 3 floats a
// pixel), velocity 15-16 (out[5], 2)
constexpr int kPlanes3 = 5;
constexpr int kOut = 3 * kPlanes3 + 2;
static_assert(kThreads % 16 == 0, "a block's mask span is whole 16-byte words");

// _ndc01 of [wp, 1] @ m.t(): the clip row as the matrix product's
// multiply-add chain in k order, then the Vulkan-flipped [0, 1] NDC
__device__ __forceinline__ void ndc01(const float* m, V3 p, float* out) {
  float c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float acc = p.x * __ldg(m + 4 * k);
    acc = fmaf(p.y, __ldg(m + 4 * k + 1), acc);
    acc = fmaf(p.z, __ldg(m + 4 * k + 2), acc);
    c[k] = fmaf(1.0f, __ldg(m + 4 * k + 3), acc);
  }
  ndc01_of(c[0], c[1], c[3], out);
}

__device__ __forceinline__ float chan_at(const GbufArgs& a, int k, int y,
                                         int x) {
  return __ldg(a.ch[k] + (y * a.st[k][0] + x * a.st[k][1]));
}

// Pixel (y, x) = p of the domain, covered: its 17 outputs into ``o``.
__device__ __forceinline__ void gbuffer_pixel(const GbufArgs& a, int p, int y,
                                              int x, float* o) {
  // the material columns: the caller's planes, or the megakernel's row
  const float* mat_row = nullptr;
  if (a.mat_id != nullptr) {
    int mid = (int)rintf(
        __ldg(a.mat_id + (y * a.mat_id_st[0] + x * a.mat_id_st[1])));
    mid = min(max(mid, 0), a.n_materials - 1);  // in range by construction
    mat_row = a.materials + mid * a.mat_stride;
  }
  auto mat = [&](int k) -> float {
    return mat_row != nullptr ? __ldg(mat_row + a.mat_col[k])
                              : chan_at(a, kGeo + k, y, x);
  };

  const V3 wp = v3(chan_at(a, 0, y, x), chan_at(a, 1, y, x),
                   chan_at(a, 2, y, x));
  const V3 n_in = v3(chan_at(a, 3, y, x), chan_at(a, 4, y, x),
                     chan_at(a, 5, y, x));
  const float u = chan_at(a, 12, y, x);
  const float v = chan_at(a, 13, y, x);
  const float handed = chan_at(a, 14, y, x);
  const bool has_tangent = (a.ht_abs ? fabsf(handed) : handed) > 0.5f;

  // the texel anchor and bilinear weights of the sampled slots (REPEAT:
  // stack sizes are powers of two), and each gathered slot's quad, once
  int row = 0;
  float w00 = 0.0f, w10 = 0.0f, w01 = 0.0f, w11 = 0.0f;
  bool gathers = false;
#pragma unroll
  for (int k = 0; k < 5; ++k) gathers = gathers || a.slot_kind[k] == 1;
  uint4 quad[5];
  if (gathers) {
    const int base = (int)mat(a.col_stack_base);
    const float se_f = mat(a.col_stack_size);
    const int se_i = (int)se_f;
    const float xs = u * se_f - 0.5f;
    const float ys = v * se_f - 0.5f;
    const float x0 = floorf(xs);
    const float y0 = floorf(ys);
    const float fx = xs - x0;
    const float fy = ys - y0;
    const int x0i = (int)x0 & (se_i - 1);
    const int y0i = (int)y0 & (se_i - 1);
    row = base + y0i * se_i + x0i;
    if (a.row_out != nullptr) a.row_out[p] = row;
    w00 = (1.0f - fx) * (1.0f - fy);
    w10 = fx * (1.0f - fy);
    w01 = (1.0f - fx) * fy;
    w11 = fx * fy;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if (a.slot_kind[k] == 1) {
        const int g = a.slot_group[k];
        const int r = min(max(row, 0), a.group_rows[g] - 1);
        quad[k] = __ldg(reinterpret_cast<const uint4*>(
            a.groups[g] + r * a.group_words[g] + a.slot_word[k]));
      }
    }
  }

  // channel c of slot k, bilinearly filtered (the plain version's chan);
  // each (k, c) is asked for once
  auto chan = [&](int k, int c) -> float {
    const int kind = a.slot_kind[k];
    if (kind == 0) return mat(a.col_const[k] + c);
    if (kind == 2) return __ldg(a.sk + (a.slot_plane[k][c] * a.h * a.w + p));
    const uint4 q = quad[k];
    const unsigned s = 8u * (unsigned)c;
    const float v0 = unorm8(q.x, s, a.inv255);
    const float v1 = unorm8(q.y, s, a.inv255);
    const float v2 = unorm8(q.z, s, a.inv255);
    const float v3v = unorm8(q.w, s, a.inv255);
    return v0 * w00 + v1 * w10 + v2 * w01 + v3v * w11;
  };

#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = srgb_to_linear(chan(0, c) * mat(a.col_base_factor + c));
    o[9 + c] = chan(4, c) * mat(a.col_emissive_factor + c);
  }
  o[12] = chan(3, 0);
  o[13] = chan(2, 1) * mat(a.col_roughness);
  o[14] = chan(2, 2) * mat(a.col_metallic);

  // TBN normal mapping (gbuffer.frag:55-60)
  const V3 n_geo = normalize_rsqrt(n_in);
  V3 nrm = n_geo;
  if (has_tangent) {
    const V3 t_in = v3(chan_at(a, 6, y, x), chan_at(a, 7, y, x),
                       chan_at(a, 8, y, x));
    const V3 bt_in = v3(chan_at(a, 9, y, x), chan_at(a, 10, y, x),
                        chan_at(a, 11, y, x));
    const V3 n_tex = normalize_rsqrt(v3(chan(1, 0) * 2.0f - 1.0f,
                                        chan(1, 1) * 2.0f - 1.0f,
                                        chan(1, 2) * 2.0f - 1.0f));
    nrm = normalize_rsqrt(
        v3(t_in.x * n_tex.x + bt_in.x * n_tex.y + n_geo.x * n_tex.z,
           t_in.y * n_tex.x + bt_in.y * n_tex.y + n_geo.y * n_tex.z,
           t_in.z * n_tex.x + bt_in.z * n_tex.y + n_geo.z * n_tex.z));
  }
  o[6] = nrm.x;
  o[7] = nrm.y;
  o[8] = nrm.z;
  o[3] = wp.x;
  o[4] = wp.y;
  o[5] = wp.z;

  // velocity: _ndc01(wp1 @ pv.T) - _ndc01(wp1 @ prev_pv.T)
  float cur[2], prev[2];
  ndc01(a.pv, wp, cur);
  ndc01(a.prev_pv, wp, prev);
  o[15] = cur[0] - prev[0];
  o[16] = cur[1] - prev[1];
}

__global__ void __launch_bounds__(kThreads) gbuffer_kernel(const GbufArgs a) {
  const int n = a.h * a.w;
  const int t = threadIdx.x;
  const int p0 = blockIdx.x * kThreads;
  const int p = p0 + t;
  float o[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) o[i] = 0.0f;  // _assemble's clear values
  bool covered = false;
  if (p < n) {
    const int y = p / a.w;
    const int x = p - y * a.w;
    covered = __ldg(a.tri + (y * a.tri_st[0] + x * a.tri_st[1])) >= 0;
    if (a.row_out != nullptr) a.row_out[p] = -1;
    if (covered) gbuffer_pixel(a, p, y, x, o);
  }
  // plane k's floats of the block's pixels, in the domain's order
  __shared__ __align__(16) float stage[kOut * kThreads];
  __shared__ __align__(16) uint8_t mask[kThreads];
#pragma unroll
  for (int k = 0; k < kPlanes3; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      stage[3 * (k * kThreads + t) + c] = o[3 * k + c];
    }
  }
  stage[3 * kPlanes3 * kThreads + 2 * t] = o[15];
  stage[3 * kPlanes3 * kThreads + 2 * t + 1] = o[16];
  mask[t] = covered ? 1 : 0;
  __syncthreads();
  if (p0 + kThreads <= n) {  // the whole span: 16-byte stores
#pragma unroll
    for (int k = 0; k <= kPlanes3; ++k) {
      const int width = k < kPlanes3 ? 3 : 2;
      const float4* src =
          reinterpret_cast<const float4*>(stage + 3 * k * kThreads);
      float4* dst = reinterpret_cast<float4*>(a.out[k] + p0 * width);
      for (int i = t; i < width * kThreads / 4; i += kThreads) dst[i] = src[i];
    }
    if (t < kThreads / 16) {
      reinterpret_cast<uint4*>(a.mask + p0)[t] =
          reinterpret_cast<const uint4*>(mask)[t];
    }
  } else {  // the domain's last block: element by element
    const int cnt = n - p0;
#pragma unroll
    for (int k = 0; k <= kPlanes3; ++k) {
      const int width = k < kPlanes3 ? 3 : 2;
      for (int i = t; i < width * cnt; i += kThreads) {
        a.out[k][p0 * width + i] = stage[3 * k * kThreads + i];
      }
    }
    if (t < cnt) a.mask[p] = mask[t];
  }
}

}  // namespace

// One launch over the G-buffer domain on ``stream``; returns
// cudaGetLastError() after it.
extern "C" int mo_gbuffer(const GbufArgs* args, void* stream) {
  const int n = args->h * args->w;
  if (n > 0) {
    gbuffer_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

// sizeof(GbufArgs), for the wrapper's check of its ctypes layout
extern "C" int mo_gbuffer_args_size() { return (int)sizeof(GbufArgs); }
