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
// What bounds it on this card: FP32 work and latency, not memory.  Per
// (triangle, pixel) candidate it does three edge evaluations and one
// depth-plane evaluation (8 multiplies, 8 adds, a few compares); a triangle
// row (64 bytes) and its box (16 bytes) are read a few times from L2 and
// the outputs written once.  The kernel's time is its heaviest tile's: a
// tile's run must be walked in draw order, so the design keeps that walk
// short (skip what a triangle's box cannot touch) and spreads one tile
// over many warps on several SMs.
//
// Design:
// - One thread block per 32 x 32 REGION, four regions to a 32 x 128 bin
//   tile (raster_common.cuh; binning is unchanged).  The four blocks read
//   the same run and keep what touches their own region, so a heavy tile
//   is walked by 64 warps on up to four SMs.  A block has 16 warps; a warp
//   owns 2 pixel rows of the region, a lane one column: 2 pixels a thread,
//   in registers; stores are 128-byte rows.  (8 warps of 4 rows were 0.002
//   ms faster on a 1.1K-triangle scene and 0.008-0.023 ms slower on a
//   52K-triangle one, H100, 1080p and a 2048^2 shadow map.)
// - The run is taken 256 pairs at a time.  Each of the first 256 threads
//   tests one triangle's inclusive pixel box (BinnedTriangles.bbox)
//   against the region; the survivors are compacted IN ORDER (warp
//   ballots, a prefix over the warp counts) into shared memory: id and
//   the box's row range inside the region.  Their 16-float rows follow by
//   cp.async, four 16-byte copies a row.
// - Staging is double-buffered and overlaps the walk: while the warps walk
//   chunk c, the copies of chunk c+1 are in flight, the boxes of chunk c+2
//   and the ids of chunk c+3 are on their way to registers.  One chunk
//   costs three barriers and no exposed load.
// - Each warp walks the survivors 32 at a time: a ballot of "row range
//   meets my rows" (warp-uniform), then the set bits in ascending order,
//   so the LessOrEqual test keeps the later triangle on ties exactly like
//   the reference's ascending chain.  Within a triangle the rows outside
//   its box are skipped (uniform branches).  A skip by box cannot change a
//   result: no pixel outside its box is ever covered (the tests hold
//   this; a triangle so large on screen that float rounding could break
//   it comes with the box of its whole tiles, raster_setup.py
//   MAX_EXACT_EXTENT), and order among the kept triangles is draw order.
// - Shared-memory row reads are 16-byte broadcasts.
//
// Arithmetic, unchanged: coverage edges are (a*px + b*py) + c with ONE
// rounding per operation (__fmul_rn / __fadd_rn, and the library builds
// with -fmad=false): contracting to FMA would move exact-on-edge pixels,
// which the top-left rule decides.  a*px is computed once per triangle and
// thread; that is the same product, not an incremental step.  Depth is
// fma(zx, px, zy*py) + zc, the reference's CPU evaluation (XLA fuses that
// multiply-add; steep depth planes amplify the difference to ~1e-5).  The
// full mode's barycentrics b_i = w_i * inv_area take w_i in that same
// fused form, as the reference computes them; the winner's are kept in
// registers beside its depth.  Triangle ids stay int32 end to end.
#include <cuda_pipeline.h>

#include "raster_common.cuh"

namespace {

using raster_common::accept;
using raster_common::fused_plane;
using raster_common::kBinH;
using raster_common::kBinW;

constexpr int kRegion = 32;                       // a block's square
constexpr int kRegionsPerTile = kBinW / kRegion;  // 4
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kRegion / kWarps;  // pixel rows of a warp (2)
constexpr int kChunk = 256;              // pairs tested per stage
constexpr int kRow = 16;                 // raster columns
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kNoRows = 0xff;  // row range (lo 255, hi 0): meets no warp

static_assert(kBinH == kRegion, "a region spans the bin tile's rows");
static_assert(kBinW % kRegion == 0, "regions tile the bin");

enum Mode { kDepth = 0, kSlim = 1, kFull = 2 };

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
  __shared__ __align__(16) float s_rows[2][kChunk][kRow];
  __shared__ int s_id[2][kChunk];
  __shared__ int s_yrange[2][kChunk];  // lo | hi << 8, rows of the region
  __shared__ int s_wcount[kWarps];

  const int tile = blockIdx.x / kRegionsPerTile;
  const int region = blockIdx.x - tile * kRegionsPerTile;
  const int ty = tile / n_tiles_x;
  const int tx = tile - ty * n_tiles_x;
  const int rx0 = tx * kBinW + region * kRegion;
  const int ry0 = ty * kBinH;
  if (rx0 >= width || ry0 >= height) return;  // the whole block

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wy0 = warp * kRows;  // the warp's first row in the region
  const int x = rx0 + lane;
  const float px = (float)x + 0.5f;

  float py[kRows];
  float z[kRows];
  int id[kRows];
  float b0[kMode == kFull ? kRows : 1];
  float b1[kMode == kFull ? kRows : 1];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    py[k] = (float)(ry0 + wy0 + k) + 0.5f;
    z[k] = 1.0f;
    id[k] = -1;
    if (kMode == kFull) {
      b0[k] = 0.0f;
      b1[k] = 0.0f;
    }
  }

  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const int n_chunks = (count + kChunk - 1) / kChunk;

  // this thread's pair of chunk c: its triangle id, or -1 past the run
  auto load_id = [&](int c) -> int {
    const int i = c * kChunk + (int)threadIdx.x;
    return (threadIdx.x < kChunk) & (i < count) ? pair_tri[start + i] : -1;
  };
  auto load_box = [&](int t) -> int4 {
    return t >= 0 ? boxes[t] : make_int4(1, 1, 0, 0);
  };

  // Test this thread's triangle against the region, compact the survivors
  // in order into buffer `buf`, start the copies of their rows.  Returns
  // the survivor count.  Two barriers.
  auto stage = [&](int buf, int t, int4 bb) -> int {
    const bool hit = (t >= 0) & (bb.x <= rx0 + kRegion - 1) & (bb.z >= rx0) &
                     (bb.y <= ry0 + kRegion - 1) & (bb.w >= ry0);
    const unsigned m = __ballot_sync(kAllLanes, hit);
    if (lane == 0) s_wcount[warp] = __popc(m);
    __syncthreads();
    int base = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_wcount[w];
      n += c;
      if (w < warp) base += c;
    }
    if (hit) {
      const int pos = base + __popc(m & ((1u << lane) - 1u));
      const int lo = max(bb.y - ry0, 0);
      const int hi = min(bb.w - ry0, kRegion - 1);
      s_id[buf][pos] = t;
      s_yrange[buf][pos] = lo | (hi << 8);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < n * (kRow / 4); j += kThreads) {
      const int r = j >> 2;
      const int part = (j & 3) * 4;
      __pipeline_memcpy_async(
          &s_rows[buf][r][part],
          tri_data + (size_t)s_id[buf][r] * kRow + part, 16);
    }
    __pipeline_commit();
    return n;
  };

  // One survivor as a warp reads it: the row as four 16-byte broadcasts
  // (a0 a1 a2 b0 | b1 b2 c0 c1 | c2 zx zy zc | inv_area tie id valid), the
  // id, and the first and last of the warp's rows inside its box.
  struct Tri {
    float4 A, B, C, D;
    int id, lo, hi;
  };
  auto fetch = [&](int buf, int r, int yr) -> Tri {
    const float4* R = reinterpret_cast<const float4*>(s_rows[buf][r]);
    return Tri{R[0], R[1], R[2], R[3], s_id[buf][r],
               (yr & 0xff) - wy0, (yr >> 8) - wy0};
  };
  auto draw = [&](const Tri& t) {
    const int tb = (int)t.D.y;
    const bool t0 = (tb & 1) != 0;
    const bool t1 = (tb & 2) != 0;
    const bool t2 = (tb & 4) != 0;
    const float ax0 = __fmul_rn(t.A.x, px);
    const float ax1 = __fmul_rn(t.A.y, px);
    const float ax2 = __fmul_rn(t.A.z, px);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (k < t.lo || k > t.hi) continue;  // warp-uniform
      const float w0 =
          __fadd_rn(__fadd_rn(ax0, __fmul_rn(t.A.w, py[k])), t.B.z);
      const float w1 =
          __fadd_rn(__fadd_rn(ax1, __fmul_rn(t.B.x, py[k])), t.B.w);
      const float w2 =
          __fadd_rn(__fadd_rn(ax2, __fmul_rn(t.B.y, py[k])), t.C.x);
      const float zz = fused_plane(t.C.y, t.C.z, t.C.w, px, py[k]);
      // bitwise &, not &&: a short-circuit lets the compiler branch per
      // pixel, which ran 1.5-1.8x slower on an H100
      const bool cover = accept(w0, t0) & accept(w1, t1) & accept(w2, t2) &
                         (zz >= 0.0f);
      if (kMode == kDepth) {
        if (cover) z[k] = fminf(zz, z[k]);
      } else if (cover && zz <= z[k]) {
        z[k] = zz;
        id[k] = t.id;
        if (kMode == kFull) {
          b0[k] = __fmul_rn(
              fused_plane(t.A.x, t.A.w, t.B.z, px, py[k]), t.D.x);
          b1[k] = __fmul_rn(
              fused_plane(t.A.y, t.B.x, t.B.w, px, py[k]), t.D.x);
        }
      }
    }
  };

  // The warp's walk over the n survivors of buffer `buf`, in order: 32 at
  // a time, those whose rows meet the warp's; the next one's row is read
  // while the current one is drawn.
  auto walk = [&](int buf, int n) {
    for (int r0 = 0; r0 < n; r0 += 32) {
      const int mine = r0 + lane < n ? s_yrange[buf][r0 + lane] : kNoRows;
      unsigned m = __ballot_sync(
          kAllLanes,
          ((mine & 0xff) <= wy0 + kRows - 1) & ((mine >> 8) >= wy0));
      if (!m) continue;  // warp-uniform, like every branch on m
      int j = __ffs(m) - 1;
      m &= m - 1;
      Tri cur = fetch(buf, r0 + j, __shfl_sync(kAllLanes, mine, j));
      while (m) {
        j = __ffs(m) - 1;
        m &= m - 1;
        const Tri next = fetch(buf, r0 + j, __shfl_sync(kAllLanes, mine, j));
        draw(cur);
        cur = next;
      }
      draw(cur);
    }
  };

  if (n_chunks > 0) {
    // registers in flight: ids two chunks ahead, boxes one chunk ahead
    int t_next = load_id(0);
    int4 box_next = load_box(t_next);
    int t_after = load_id(1);
    int n_cur = stage(0, t_next, box_next);
    t_next = t_after;
    box_next = load_box(t_next);
    t_after = load_id(2);
    for (int c = 0; c < n_chunks; ++c) {
      // chunk c's rows have landed; every warp is done with chunk c-1
      __pipeline_wait_prior(0);
      __syncthreads();
      int n_next = 0;
      if (c + 1 < n_chunks) {  // block-uniform
        n_next = stage((c + 1) & 1, t_next, box_next);
        t_next = t_after;
        box_next = load_box(t_next);
        t_after = load_id(c + 3);
      }
      walk(c & 1, n_cur);
      n_cur = n_next;
    }
  }

  if (x >= width) return;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int y = ry0 + wy0 + k;
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
