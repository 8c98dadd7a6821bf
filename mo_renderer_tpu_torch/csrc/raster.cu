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
// What bounds it on this card, and the whole design, is the region walk of
// raster_common.cuh (FP32 work and latency of the heaviest tile, not
// memory): one 512-thread block per 32 x 32 region, box cull, cp.async
// double buffer.  This file adds only the stores: a warp writes 128-byte
// rows of depth, id and (full mode) the winner's barycentrics.
#include "raster_common.cuh"

namespace {

using namespace raster_common;

template <int kMode>
__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ tri_data,
              const int4* __restrict__ boxes,
              const int* __restrict__ pair_tri,
              const int* __restrict__ tile_start,
              const int* __restrict__ tile_count, float* __restrict__ z_out,
              int* __restrict__ tri_out, float* __restrict__ b0_out,
              float* __restrict__ b1_out, int width, int height,
              int n_tiles_x) {
  const Place at = place_of_thread(n_tiles_x);
  if (at.rx0 >= width || at.ry0 >= height) return;  // the whole block
  const Winners<kMode> win = walk_region<kMode>(
      at, tri_data, boxes, pair_tri, tile_start, tile_count);

  if (at.x >= width) return;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int y = at.ry0 + at.wy0 + k;
    if (y < height) {
      const size_t o = (size_t)y * width + at.x;
      z_out[o] = win.z[k];
      if (kMode != kDepth) tri_out[o] = win.z[k] < 1.0f ? win.id[k] : -1;
      if (kMode == kFull) {
        b0_out[o] = win.b0[k];
        b1_out[o] = win.b1[k];
      }
    }
  }
}

template <int kMode>
void launch(const void* tri_data, const void* boxes, const void* pair_tri,
            const void* tile_start, const void* tile_count, void* z_out,
            void* tri_out, void* b0_out, void* b1_out, int width, int height,
            int n_tiles_x, int n_tiles, cudaStream_t s) {
  raster_kernel<kMode><<<n_tiles * kRegionsPerTile, kThreads, 0, s>>>(
      (const float*)tri_data, (const int4*)boxes, (const int*)pair_tri,
      (const int*)tile_start, (const int*)tile_count, (float*)z_out,
      (int*)tri_out, (float*)b0_out, (float*)b1_out, width, height,
      n_tiles_x);
}

}  // namespace

// mode: 0 depth-only (K2), 1 slim visibility (K1), 2 full (K6).  tri_data
// rows are 16 floats and boxes 4 ints (x0, y0, x1, y1 inclusive), both
// 16-byte aligned.
extern "C" int mo_raster(const void* tri_data, const void* boxes,
                         const void* pair_tri, const void* tile_start,
                         const void* tile_count, void* z_out, void* tri_out,
                         void* b0_out, void* b1_out, int width, int height,
                         int n_tiles_x, int n_tiles_y, int mode,
                         void* stream) {
  const int n_tiles = n_tiles_x * n_tiles_y;
  if (n_tiles <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kDepth) {
    launch<kDepth>(tri_data, boxes, pair_tri, tile_start, tile_count, z_out,
                   tri_out, b0_out, b1_out, width, height, n_tiles_x,
                   n_tiles, s);
  } else if (mode == kSlim) {
    launch<kSlim>(tri_data, boxes, pair_tri, tile_start, tile_count, z_out,
                  tri_out, b0_out, b1_out, width, height, n_tiles_x, n_tiles,
                  s);
  } else {
    launch<kFull>(tri_data, boxes, pair_tri, tile_start, tile_count, z_out,
                   tri_out, b0_out, b1_out, width, height, n_tiles_x,
                   n_tiles, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mo_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
