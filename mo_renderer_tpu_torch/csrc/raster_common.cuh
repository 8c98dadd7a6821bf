// The region walk shared by the tile rasterizers: raster.cu (K1 slim, K2
// depth-only, K6 full) and raster_attrs.cu (K8, the megakernel).  It
// replaces the row loops of the TPU kernels in
// mo_renderer_tpu/kernels/rasterizer.py (_process_rows_slim:48,
// _process_rows:85, _process_rows_attrs:141): given a bin tile's run of
// triangles in draw order, find per pixel the covering triangle that wins
// the LessOrEqual depth test.
//
// What bounds it on this card: FP32 work and latency, not memory.  Per
// (triangle, pixel) candidate it does three edge evaluations and one
// depth-plane evaluation (8 multiplies, 8 adds, a few compares); a triangle
// row (64 bytes) and its box (16 bytes) are read a few times from L2.  Its
// time is its heaviest tile's: a tile's run must be walked in draw order,
// so the design keeps that walk short (skip what a triangle's box cannot
// touch) and spreads one tile over many warps on several SMs.
//
// Design:
// - One thread block per 32 x 32 REGION, four regions to a 32 x 128 bin
//   tile (binning is by tile).  The four blocks read the same run and keep
//   what touches their own region, so a heavy tile is walked by 64 warps
//   on up to four SMs.  A block has 16 warps; a warp owns 2 pixel rows of
//   the region, a lane one column: 2 pixels a thread, in registers, and a
//   warp's stores are 128-byte rows.  (8 warps of 4 rows were 0.002 ms
//   faster on a 1.1K-triangle scene and 0.008-0.023 ms slower on a
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
// Arithmetic: coverage edges are (a*px + b*py) + c with ONE rounding per
// operation (__fmul_rn / __fadd_rn, and the library builds with
// -fmad=false): contracting to FMA would move exact-on-edge pixels, which
// the top-left rule decides.  a*px is computed once per triangle and
// thread; that is the same product, not an incremental step.  Depth is
// fma(zx, px, zy*py) + zc, the reference's CPU evaluation (XLA fuses that
// multiply-add; steep depth planes amplify the difference to ~1e-5).  The
// full mode's barycentrics b_i = w_i * inv_area take w_i in that same
// fused form, as the reference computes them; the winner's are kept in
// registers beside its depth.  Triangle ids stay int32 end to end.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace raster_common {

constexpr int kBinH = 32;  // the bin tile of kernels/rasterizer.py
constexpr int kBinW = 128;
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

// Where a block and one of its threads stand: the bin tile, the region's
// first pixel, the warp's first row inside the region, the thread's column.
struct Place {
  int tile, rx0, ry0, lane, wy0, x;
};

// tile0 is the first bin tile of the launch: a band raster starts at
// a later tile row of the frame's bins, and every row it draws is a row of
// the whole frame.
__device__ __forceinline__ Place place_of_thread(int n_tiles_x,
                                                 int tile0 = 0) {
  Place at;
  const int local = blockIdx.x / kRegionsPerTile;
  const int region = blockIdx.x - local * kRegionsPerTile;
  at.tile = tile0 + local;
  const int ty = at.tile / n_tiles_x;
  const int tx = at.tile - ty * n_tiles_x;
  at.rx0 = tx * kBinW + region * kRegion;
  at.ry0 = ty * kBinH;
  at.lane = threadIdx.x & 31;
  at.wy0 = (threadIdx.x >> 5) * kRows;
  at.x = at.rx0 + at.lane;
  return at;
}

// A thread's pixels after the walk: depth (1 where nothing covers), the
// winner's id (-1 where none) and, in full mode, its barycentrics.
template <int kMode>
struct Winners {
  float z[kRows];
  int id[kRows];
  float b0[kMode == kFull ? kRows : 1];
  float b1[kMode == kFull ? kRows : 1];
};

// Walk the run of the block's bin tile over the block's region.  Every
// thread of the block calls it (it holds barriers).
template <int kMode>
__device__ __forceinline__ Winners<kMode> walk_region(
    const Place& at, const float* __restrict__ tri_data,
    const int4* __restrict__ boxes, const int* __restrict__ pair_tri,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count) {
  __shared__ __align__(16) float s_rows[2][kChunk][kRow];
  __shared__ int s_id[2][kChunk];
  __shared__ int s_yrange[2][kChunk];  // lo | hi << 8, rows of the region
  __shared__ int s_wcount[kWarps];

  const int rx0 = at.rx0;
  const int ry0 = at.ry0;
  const int lane = at.lane;
  const int warp = threadIdx.x >> 5;
  const int wy0 = at.wy0;
  const float px = (float)at.x + 0.5f;

  float py[kRows];
  Winners<kMode> win;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    py[k] = (float)(ry0 + wy0 + k) + 0.5f;
    win.z[k] = 1.0f;
    win.id[k] = -1;
    if (kMode == kFull) {
      win.b0[k] = 0.0f;
      win.b1[k] = 0.0f;
    }
  }

  const int start = tile_start[at.tile];
  const int count = tile_count[at.tile];
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
        if (cover) win.z[k] = fminf(zz, win.z[k]);
      } else if (cover && zz <= win.z[k]) {
        win.z[k] = zz;
        win.id[k] = t.id;
        if (kMode == kFull) {
          win.b0[k] = __fmul_rn(
              fused_plane(t.A.x, t.A.w, t.B.z, px, py[k]), t.D.x);
          win.b1[k] = __fmul_rn(
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
  return win;
}

}  // namespace raster_common
