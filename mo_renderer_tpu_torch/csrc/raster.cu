// Tile rasterizer: visibility buffer (triangle id + depth), its full mode
// with the winner's screen-space barycentrics, and the depth-only shadow
// map.
//
// Replaces the TPU kernels of mo_renderer_tpu/kernels/rasterizer.py:
//   K1 rasterize(slim=True)       (_make_kernel:366, _process_rows_slim:48)
//   K6 rasterize() full mode      (_process_rows:85 with b0/b1)
//   K2 rasterize(depth_only=True) (_process_rows:85 in depth mode)
// all reaching pl.pallas_call at rasterizer.py:649.  One kernel with a
// compile-time mode serves the three.  Its band form (K1b slim, K2b
// depth-only: rasterize(tile_row_offset=...), rasterizer.py:560, :617-629,
// the row-sharded frame's raster) draws the height-tall band that
// starts at bin row tile_row_offset of the frame's bins: the blocks
// start at that row's tiles and every pixel keeps its row in the whole
// frame, so edges, depth and winners are the whole frame's; only the
// store moves the row into the band's plane.  The whole-frame entry does
// not take the offset (kBand false), so its code is unchanged.
//
// What bounds it on this card, and the whole design, is the region walk of
// raster_common.cuh (FP32 work and latency of the heaviest tile, not
// memory): one 512-thread block per 32 x 32 region, box cull, cp.async
// double buffer.  This file adds only the stores: a warp writes 128-byte
// rows of depth, id and (full mode) the winner's barycentrics.
#include "raster_common.cuh"

namespace {

using namespace raster_common;

template <int kMode, bool kBand>
__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ tri_data,
              const int4* __restrict__ boxes,
              const int* __restrict__ pair_tri,
              const int* __restrict__ tile_start,
              const int* __restrict__ tile_count, float* __restrict__ z_out,
              int* __restrict__ tri_out, float* __restrict__ b0_out,
              float* __restrict__ b1_out, int width, int height,
              int n_tiles_x, int tile_row_offset) {
  // the band's first pixel row in the frame (0 for the whole frame)
  const int row0 = kBand ? tile_row_offset * kBinH : 0;
  const Place at =
      place_of_thread(n_tiles_x, kBand ? tile_row_offset * n_tiles_x : 0);
  if (at.rx0 >= width || at.ry0 - row0 >= height) return;  // the whole block
  const Winners<kMode> win = walk_region<kMode>(
      at, tri_data, boxes, pair_tri, tile_start, tile_count);

  if (at.x >= width) return;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int y = at.ry0 - row0 + at.wy0 + k;
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

template <int kMode, bool kBand = false>
void launch(const void* tri_data, const void* boxes, const void* pair_tri,
            const void* tile_start, const void* tile_count, void* z_out,
            void* tri_out, void* b0_out, void* b1_out, int width, int height,
            int n_tiles_x, int n_tiles, cudaStream_t s,
            int tile_row_offset = 0) {
  raster_kernel<kMode, kBand><<<n_tiles * kRegionsPerTile, kThreads, 0, s>>>(
      (const float*)tri_data, (const int4*)boxes, (const int*)pair_tri,
      (const int*)tile_start, (const int*)tile_count, (float*)z_out,
      (int*)tri_out, (float*)b0_out, (float*)b1_out, width, height,
      n_tiles_x, tile_row_offset);
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

// The band form: mode 0 depth-only (K2b) or 1 slim (K1b).  Draws the
// height-tall band that starts at bin row tile_row_offset (of
// kBinH rows) of bins laid out for the whole frame, n_tiles_x bins a row;
// the caller's run table must reach the band's last bin row.
extern "C" int mo_raster_band(const void* tri_data, const void* boxes,
                              const void* pair_tri, const void* tile_start,
                              const void* tile_count, void* z_out,
                              void* tri_out, int width, int height,
                              int n_tiles_x, int tile_row_offset, int mode,
                              void* stream) {
  const int n_tiles = n_tiles_x * ((height + kBinH - 1) / kBinH);
  if (n_tiles <= 0) return (int)cudaGetLastError();
  if (tile_row_offset < 0 || (mode != kDepth && mode != kSlim)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kDepth) {
    launch<kDepth, true>(tri_data, boxes, pair_tri, tile_start, tile_count,
                         z_out, nullptr, nullptr, nullptr, width, height,
                         n_tiles_x, n_tiles, s, tile_row_offset);
  } else {
    launch<kSlim, true>(tri_data, boxes, pair_tri, tile_start, tile_count,
                        z_out, tri_out, nullptr, nullptr, width, height,
                        n_tiles_x, n_tiles, s, tile_row_offset);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mo_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
