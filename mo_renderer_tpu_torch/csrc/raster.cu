// Tile rasterizer: visibility buffer (triangle id + depth), its full mode
// with the winner's screen-space barycentrics, and the depth-only shadow
// map.
//
// Replaces the TPU kernels of mo_renderer_tpu/kernels/rasterizer.py:
//   K1 rasterize(slim=True)       (_make_kernel:366, _process_rows_slim:48)
//   K6 rasterize() full mode      (_process_rows:85 with b0/b1)
//   K2 rasterize(depth_only=True) (_process_rows:85 in depth mode)
// all reaching pl.pallas_call at rasterizer.py:649.  One kernel with a
// compile-time mode serves the three.
//
// What bounds it on this card: per (triangle, pixel) candidate it does
// three edge evaluations and one depth-plane evaluation (8 multiplies, 8
// adds, a few compares) -- FP32 issue and the serial walk over each tile's
// run.  Memory traffic is small: a triangle row (64 bytes) is read once per
// tile and reused by the tile's 4096 pixels; outputs are written once.
//
// Design: one thread block per 32 x 128 bin tile (raster_common.cuh).  The
// tile's run of triangle ids (sorted by draw order by the binner) is staged
// through shared memory 64 rows at a time; every thread then walks the
// staged rows in order, so the LessOrEqual test keeps the later triangle on
// ties exactly like the reference's ascending chain.  Shared-memory row
// reads are broadcasts.  Stores are coalesced per pixel row.
//
// Arithmetic: coverage edges are (a*px + b*py) + c with ONE rounding per
// operation (__fmul_rn / __fadd_rn, and the library builds with
// -fmad=false): contracting to FMA would move exact-on-edge pixels, which
// the top-left rule decides.  Depth is fma(zx, px, zy*py) + zc, the
// reference's CPU evaluation (XLA fuses that multiply-add; steep depth
// planes amplify the difference to ~1e-5).  The full mode's barycentrics
// b_i = w_i * inv_area take w_i in that same fused form, as the reference
// computes them; the winner's are kept in registers beside its depth.
// Triangle ids stay int32 end to end.
#include "raster_common.cuh"

namespace {

using namespace raster_common;

enum Mode { kDepth = 0, kSlim = 1, kFull = 2 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ tri_data,
              const int* __restrict__ pair_tri,
              const int* __restrict__ tile_start,
              const int* __restrict__ tile_count, float* __restrict__ z_out,
              int* __restrict__ tri_out, float* __restrict__ b0_out,
              float* __restrict__ b1_out, int width, int height,
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
  float b0[kMode == kFull ? kPix : 1];
  float b1[kMode == kFull ? kPix : 1];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    z[k] = 1.0f;
    id[k] = -1;
    if (kMode == kFull) {
      b0[k] = 0.0f;
      b1[k] = 0.0f;
    }
  }

  const int start = tile_start[tile];
  const int count = tile_count[tile];
  for (int c0 = 0; c0 < count; c0 += kChunk) {
    const int n = min(kChunk, count - c0);
    __syncthreads();  // previous chunk fully consumed
    for (int i = threadIdx.x; i < n * kRow; i += kThreads) {
      const int r = i / kRow;
      const int col = i - r * kRow;
      const int t = pair_tri[start + c0 + r];
      rows[r][col] = tri_data[(size_t)t * kRow + col];
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
        // per pixel, which ran 1.5-1.8x slower on an H100 (1080p frame inputs)
        const bool cover = accept(w0, t0) & accept(w1, t1) &
                           accept(w2, t2) & (zz >= 0.0f);
        if (kMode == kDepth) {
          if (cover) z[k] = fminf(zz, z[k]);
        } else if (cover && zz <= z[k]) {
          z[k] = zz;
          id[k] = rid;
          if (kMode == kFull) {
            b0[k] = __fmul_rn(fused_plane(R[0], R[3], R[6], px, py), R[12]);
            b1[k] = __fmul_rn(fused_plane(R[1], R[4], R[7], px, py), R[12]);
          }
        }
      }
    }
  }

  if (x >= width) return;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int y = y0 + kRowsPerSweep * k;
    if (y < height) {
      const size_t o = (size_t)y * width + x;
      z_out[o] = z[k];
      if (kMode != kDepth) tri_out[o] = z[k] < 1.0f ? id[k] : -1;
      if (kMode == kFull) {
        b0_out[o] = b0[k];
        b1_out[o] = b1[k];
      }
    }
  }
}

template <int kMode>
void launch(const void* tri_data, const void* pair_tri,
            const void* tile_start, const void* tile_count, void* z_out,
            void* tri_out, void* b0_out, void* b1_out, int width, int height,
            int n_tiles_x, int n_tiles, cudaStream_t s) {
  raster_kernel<kMode><<<n_tiles, kThreads, 0, s>>>(
      (const float*)tri_data, (const int*)pair_tri, (const int*)tile_start,
      (const int*)tile_count, (float*)z_out, (int*)tri_out, (float*)b0_out,
      (float*)b1_out, width, height, n_tiles_x);
}

}  // namespace

// mode: 0 depth-only (K2), 1 slim visibility (K1), 2 full (K6).
extern "C" int mo_raster(const void* tri_data, const void* pair_tri,
                         const void* tile_start, const void* tile_count,
                         void* z_out, void* tri_out, void* b0_out,
                         void* b1_out, int width, int height, int n_tiles_x,
                         int n_tiles_y, int mode, void* stream) {
  const int n_tiles = n_tiles_x * n_tiles_y;
  if (n_tiles <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kDepth) {
    launch<kDepth>(tri_data, pair_tri, tile_start, tile_count, z_out,
                   tri_out, b0_out, b1_out, width, height, n_tiles_x,
                   n_tiles, s);
  } else if (mode == kSlim) {
    launch<kSlim>(tri_data, pair_tri, tile_start, tile_count, z_out, tri_out,
                  b0_out, b1_out, width, height, n_tiles_x, n_tiles, s);
  } else {
    launch<kFull>(tri_data, pair_tri, tile_start, tile_count, z_out, tri_out,
                  b0_out, b1_out, width, height, n_tiles_x, n_tiles, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mo_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
