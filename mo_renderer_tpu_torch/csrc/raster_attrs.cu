// Raster megakernel: visibility plus the winner's perspective-correct
// attribute planes, for raster_interp_attrs=True.
//
// Replaces the TPU kernel K8 of mo_renderer_tpu/kernels/rasterizer.py:
//   rasterize_attrs:288 (_make_attrs_kernel:210, _process_rows_attrs:141),
// reaching pl.pallas_call at rasterizer.py:336.
//
// Rows are 63 floats: the 16 raster columns of raster_setup, then the 47
// channel-major columns of vertex_stage.pack_raster_attr_columns (per-corner
// 1/w, 14 channels x 3 corners, material id, has_tangent).
//
// The TPU kernel interpolates all 14 channels for every candidate row and
// keeps the winner's with a one-hot sum.  Here the walk is the K1 walk
// (raster.cu): only the 16 raster columns are staged, and each pixel keeps
// its winning triangle id beside its depth.  After the walk every pixel
// with a winner reads that triangle's row once (L1/L2-resident: a tile's
// pixels share few winners) and interpolates once.  Same function, ~14x
// less arithmetic per candidate.
//
// Arithmetic, identical to the plain version in kernels/rasterizer.py:
//   w_i = fma(a_i, px, b_i*py) + c_i      (the reference's CPU form)
//   bb_i = w_i * inv_area,  q_i = bb_i * iw_i,  qs = (q0 + q1) + q2
//   rs = 1 / (|qs| > 1e-20 ? qs : 1),   ob_i = q_i * rs
//   v = (ob0 * a0 + ob1 * a1) + ob2 * a2  per channel, one rounding per op.
// Outputs: z, tri (int32, -1 where z >= 1) and 16 planes (14 channels,
// material id, has_tangent); zeros where no triangle won.
#include "raster_common.cuh"

namespace {

using namespace raster_common;

constexpr int kAttrRow = 63;
constexpr int kNInterp = 14;
constexpr int kColIw = 16;
constexpr int kColAttr = 19;
constexpr int kNPlanes = kNInterp + 2;

__global__ void __launch_bounds__(kThreads)
raster_attrs_kernel(const float* __restrict__ tri_data,
                    const int* __restrict__ pair_tri,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ tile_count,
                    float* __restrict__ z_out, int* __restrict__ tri_out,
                    float* __restrict__ planes, int width, int height,
                    int n_tiles_x) {
  __shared__ float rows[kChunk][kRow];
  __shared__ int ids[kChunk];

  const int tile = blockIdx.x;
  const int ty = tile / n_tiles_x;
  const int tx = tile - ty * n_tiles_x;
  const int x = tx * kBinW + (threadIdx.x % kBinW);
  const int y0 = ty * kBinH + threadIdx.x / kBinW;
  const float px = (float)x + 0.5f;

  float z[kPix];
  int id[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    z[k] = 1.0f;
    id[k] = -1;
  }

  const int start = tile_start[tile];
  const int count = tile_count[tile];
  for (int c0 = 0; c0 < count; c0 += kChunk) {
    const int n = min(kChunk, count - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * kRow; i += kThreads) {
      const int r = i / kRow;
      const int col = i - r * kRow;
      const int t = pair_tri[start + c0 + r];
      rows[r][col] = tri_data[(size_t)t * kAttrRow + col];
    }
    for (int i = threadIdx.x; i < n; i += kThreads) {
      ids[i] = pair_tri[start + c0 + i];
    }
    __syncthreads();

    for (int r = 0; r < n; ++r) {
      const float* R = rows[r];
      const int tb = (int)R[13];
      const bool t0 = (tb & 1) != 0;
      const bool t1 = (tb & 2) != 0;
      const bool t2 = (tb & 4) != 0;
      const int rid = ids[r];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const float py = (float)(y0 + kRowsPerSweep * k) + 0.5f;
        const float w0 = plane(R[0], R[3], R[6], px, py);
        const float w1 = plane(R[1], R[4], R[7], px, py);
        const float w2 = plane(R[2], R[5], R[8], px, py);
        const float zz = fused_plane(R[9], R[10], R[11], px, py);
        // bitwise &, not &&: a short-circuit lets the compiler branch
        // per pixel, which ran 1.5x slower on an H100 (1080p frame inputs)
        const bool cover = accept(w0, t0) & accept(w1, t1) &
                           accept(w2, t2) & (zz >= 0.0f);
        if (cover && zz <= z[k]) {
          z[k] = zz;
          id[k] = rid;
        }
      }
    }
  }

  if (x >= width) return;
  const size_t plane_stride = (size_t)width * height;
  for (int k = 0; k < kPix; ++k) {
    const int y = y0 + kRowsPerSweep * k;
    if (y >= height) break;
    const size_t o = (size_t)y * width + x;
    z_out[o] = z[k];
    tri_out[o] = z[k] < 1.0f ? id[k] : -1;
    float out[kNPlanes];
    if (id[k] < 0) {
#pragma unroll
      for (int c = 0; c < kNPlanes; ++c) out[c] = 0.0f;
    } else {
      const float* R = tri_data + (size_t)id[k] * kAttrRow;
      const float py = (float)y + 0.5f;
      const float inv_area = R[12];
      float q[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float w = fused_plane(R[i], R[3 + i], R[6 + i], px, py);
        q[i] = __fmul_rn(__fmul_rn(w, inv_area), R[kColIw + i]);
      }
      const float qs = __fadd_rn(__fadd_rn(q[0], q[1]), q[2]);
      const float rs = __frcp_rn(fabsf(qs) > 1e-20f ? qs : 1.0f);
      const float ob0 = __fmul_rn(q[0], rs);
      const float ob1 = __fmul_rn(q[1], rs);
      const float ob2 = __fmul_rn(q[2], rs);
#pragma unroll
      for (int c = 0; c < kNInterp; ++c) {
        const float* A = R + kColAttr + 3 * c;
        out[c] = __fadd_rn(
            __fadd_rn(__fmul_rn(ob0, A[0]), __fmul_rn(ob1, A[1])),
            __fmul_rn(ob2, A[2]));
      }
      out[kNInterp] = R[kColAttr + 3 * kNInterp];
      out[kNInterp + 1] = R[kColAttr + 3 * kNInterp + 1];
    }
#pragma unroll
    for (int c = 0; c < kNPlanes; ++c) planes[c * plane_stride + o] = out[c];
  }
}

}  // namespace

extern "C" int mo_raster_attrs(const void* tri_data, const void* pair_tri,
                               const void* tile_start, const void* tile_count,
                               void* z_out, void* tri_out, void* planes,
                               int width, int height, int n_tiles_x,
                               int n_tiles_y, void* stream) {
  const int n_tiles = n_tiles_x * n_tiles_y;
  if (n_tiles <= 0) return (int)cudaGetLastError();
  raster_attrs_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tri_data, (const int*)pair_tri, (const int*)tile_start,
      (const int*)tile_count, (float*)z_out, (int*)tri_out, (float*)planes,
      width, height, n_tiles_x);
  return (int)cudaGetLastError();
}
