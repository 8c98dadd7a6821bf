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
// Design: one thread per pixel of the G-buffer domain.  Every input channel
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
// Arithmetic follows the plain version operation by operation, each
// rounding once (the library builds this unit with -fmad=false): the texel
// index floor(uv * size - 0.5), the pass's one discontinuity, rounds the
// multiply and the subtract separately as the two torch ops do.  Where the
// plain version's order is a library's, the kernel takes the card's: the
// clip products wp1 @ pv.t() are multiply-add chains in k order (cuBLAS),
// a division by a constant is a multiply by its float reciprocal (PyTorch's
// CUDA division by a scalar), and the (x, y, z) sums of _normalize run left
// to right before rsqrtf.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// geometry channels: wp 0-2, n 3-5, t 6-8, bt 9-11, uv0 12-13, handedness 14
constexpr int kGeo = 15;
// material columns: materials.fast_used_cols is 11 + 4 per constant slot
constexpr int kMaxMat = 31;

// What the kernel reads, filled by passes/gbuffer.py tail_args (its
// GbufArgs ctypes structure mirrors this one field for field).
struct GbufArgs {
  const float* ch[kGeo + kMaxMat];  // per channel: its (H, W) plane
  long long st[kGeo + kMaxMat][2];  // row and column strides, in elements
  const int* tri;                   // (H, W) visibility ids
  long long tri_st[2];
  const float* mat_id;  // megakernel: (H, W) material ids, else null
  long long mat_id_st[2];
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

constexpr int kThreads = 256;

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

// _normalize: v * rsqrt(clamp((v * v).sum(-1), min=1e-20))
__device__ __forceinline__ V3 normalize_rsqrt(V3 v) {
  const float ss = (v.x * v.x + v.y * v.y) + v.z * v.z;
  const float r = rsqrtf(ss < (float)1e-20 ? (float)1e-20 : ss);
  return v3(v.x * r, v.y * r, v.z * r);
}

// kernels/tonemap.py srgb_to_linear: the 0.04045 branch, powf(., 2.4)
__device__ __forceinline__ float srgb_to_linear(float s) {
  if (s < 0.04045f) return s * (1.0f / 12.92f);
  const float t = (s + 0.055f) * (1.0f / 1.055f);
  return powf(t < 0.0f ? 0.0f : t, 2.4f);  // torch.clamp passes a NaN on
}

// _ndc01 of [wp, 1] @ m.t(): the clip row as the matrix product's
// multiply-add chain in k order, then the Vulkan-flipped [0, 1] NDC
__device__ __forceinline__ void ndc01(const float* m, V3 p, float* out) {
  float c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float acc = p.x * m[4 * k];
    acc = fmaf(p.y, m[4 * k + 1], acc);
    acc = fmaf(p.z, m[4 * k + 2], acc);
    c[k] = fmaf(1.0f, m[4 * k + 3], acc);
  }
  const float wc = fabsf(c[3]) > (float)1e-20 ? c[3] : 1.0f;
  out[0] = (c[0] / wc + 1.0f) * 0.5f;
  out[1] = 1.0f - (c[1] / wc + 1.0f) * 0.5f;
}

__device__ __forceinline__ float chan_at(const GbufArgs& a, int k, int y,
                                         int x) {
  return a.ch[k][y * a.st[k][0] + x * a.st[k][1]];
}

__global__ void __launch_bounds__(kThreads)
    gbuffer_kernel(const GbufArgs a) {
  const int n = a.h * a.w;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int y = p / a.w;
  const int x = p - y * a.w;
  const bool covered = a.tri[y * a.tri_st[0] + x * a.tri_st[1]] >= 0;
  a.mask[p] = covered ? 1 : 0;
  if (a.row_out != nullptr) a.row_out[p] = -1;
  float* base_out = a.out[0] + (size_t)p * 3;
  float* pos_out = a.out[1] + (size_t)p * 3;
  float* nrm_out = a.out[2] + (size_t)p * 3;
  float* emis_out = a.out[3] + (size_t)p * 3;
  float* orm_out = a.out[4] + (size_t)p * 3;
  float* vel_out = a.out[5] + (size_t)p * 2;
  if (!covered) {  // _assemble's clear values
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      base_out[c] = pos_out[c] = nrm_out[c] = emis_out[c] = orm_out[c] = 0.0f;
    }
    vel_out[0] = vel_out[1] = 0.0f;
    return;
  }

  // the material columns: the caller's planes, or the megakernel's row
  const float* mat_row = nullptr;
  if (a.mat_id != nullptr) {
    int mid = (int)rintf(a.mat_id[y * a.mat_id_st[0] + x * a.mat_id_st[1]]);
    mid = min(max(mid, 0), a.n_materials - 1);  // in range by construction
    mat_row = a.materials + (size_t)mid * a.mat_stride;
  }
  auto mat = [&](int k) -> float {
    return mat_row != nullptr ? mat_row[a.mat_col[k]]
                              : chan_at(a, kGeo + k, y, x);
  };

  const V3 wp = v3(chan_at(a, 0, y, x), chan_at(a, 1, y, x),
                   chan_at(a, 2, y, x));
  const V3 n_in = v3(chan_at(a, 3, y, x), chan_at(a, 4, y, x),
                     chan_at(a, 5, y, x));
  const V3 t_in = v3(chan_at(a, 6, y, x), chan_at(a, 7, y, x),
                     chan_at(a, 8, y, x));
  const V3 bt_in = v3(chan_at(a, 9, y, x), chan_at(a, 10, y, x),
                      chan_at(a, 11, y, x));
  const float u = chan_at(a, 12, y, x);
  const float v = chan_at(a, 13, y, x);
  const float handed = chan_at(a, 14, y, x);
  const bool has_tangent = (a.ht_abs ? fabsf(handed) : handed) > 0.5f;

  // the texel anchor and bilinear weights of the sampled slots (REPEAT:
  // stack sizes are powers of two)
  int row = 0;
  float w00 = 0.0f, w10 = 0.0f, w01 = 0.0f, w11 = 0.0f;
  bool gathers = false;
#pragma unroll
  for (int k = 0; k < 5; ++k) gathers = gathers || a.slot_kind[k] == 1;
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
  }

  // channel c of slot k, bilinearly filtered (the plain version's chan)
  auto chan = [&](int k, int c) -> float {
    const int kind = a.slot_kind[k];
    if (kind == 0) return mat(a.col_const[k] + c);
    if (kind == 2) {
      return a.sk[(size_t)a.slot_plane[k][c] * n + p];
    }
    const int g = a.slot_group[k];
    const int r = min(max(row, 0), a.group_rows[g] - 1);
    const uint4 q = *reinterpret_cast<const uint4*>(
        a.groups[g] + (size_t)r * a.group_words[g] + a.slot_word[k]);
    const unsigned s = 8u * (unsigned)c;
    const float v0 = (float)((q.x >> s) & 0xFFu) * a.inv255;
    const float v1 = (float)((q.y >> s) & 0xFFu) * a.inv255;
    const float v2 = (float)((q.z >> s) & 0xFFu) * a.inv255;
    const float v3v = (float)((q.w >> s) & 0xFFu) * a.inv255;
    return v0 * w00 + v1 * w10 + v2 * w01 + v3v * w11;
  };

#pragma unroll
  for (int c = 0; c < 3; ++c) {
    base_out[c] = srgb_to_linear(chan(0, c) * mat(a.col_base_factor + c));
    emis_out[c] = chan(4, c) * mat(a.col_emissive_factor + c);
  }
  orm_out[0] = chan(3, 0);
  orm_out[1] = chan(2, 1) * mat(a.col_roughness);
  orm_out[2] = chan(2, 2) * mat(a.col_metallic);

  // TBN normal mapping (gbuffer.frag:55-60)
  const V3 n_geo = normalize_rsqrt(n_in);
  V3 nrm = n_geo;
  if (has_tangent) {
    const V3 n_tex = normalize_rsqrt(v3(chan(1, 0) * 2.0f - 1.0f,
                                        chan(1, 1) * 2.0f - 1.0f,
                                        chan(1, 2) * 2.0f - 1.0f));
    nrm = normalize_rsqrt(
        v3(t_in.x * n_tex.x + bt_in.x * n_tex.y + n_geo.x * n_tex.z,
           t_in.y * n_tex.x + bt_in.y * n_tex.y + n_geo.y * n_tex.z,
           t_in.z * n_tex.x + bt_in.z * n_tex.y + n_geo.z * n_tex.z));
  }
  nrm_out[0] = nrm.x;
  nrm_out[1] = nrm.y;
  nrm_out[2] = nrm.z;
  pos_out[0] = wp.x;
  pos_out[1] = wp.y;
  pos_out[2] = wp.z;

  // velocity: _ndc01(wp1 @ pv.T) - _ndc01(wp1 @ prev_pv.T)
  float cur[2], prev[2];
  ndc01(a.pv, wp, cur);
  ndc01(a.prev_pv, wp, prev);
  vel_out[0] = cur[0] - prev[0];
  vel_out[1] = cur[1] - prev[1];
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
