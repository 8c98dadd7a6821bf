// Shared by the tile rasterizers (raster.cu, raster_attrs.cu): the bin
// tile, the thread layout and the edge / depth plane arithmetic.
//
// One thread block per 32 x 128 bin tile; 256 threads, each owning 16
// pixels of one column (rows r, r+2, ..., r+30) in registers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace raster_common {

constexpr int kBinH = 32;
constexpr int kBinW = 128;
constexpr int kThreads = 256;
constexpr int kRowsPerSweep = kThreads / kBinW;         // 2
constexpr int kPix = kBinH * kBinW / kThreads;          // 16
constexpr int kChunk = 64;                              // rows staged at once
constexpr int kRow = 16;                                // raster columns

// Edge value for coverage: (a*px + b*py) + c, one rounding per operation
// (the sign decides exact-on-edge pixels through the top-left rule).
__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

// fma(a, px, b*py) + c: the reference's CPU evaluation of the depth plane
// and of the edge values its barycentrics are built from (XLA fuses that
// multiply-add there).
__device__ __forceinline__ float fused_plane(float a, float b, float c,
                                             float px, float py) {
  return __fadd_rn(fmaf(a, px, __fmul_rn(b, py)), c);
}

__device__ __forceinline__ bool accept(float w, bool tie) {
  return (w > 0.0f) || (tie && w == 0.0f);
}

}  // namespace raster_common
