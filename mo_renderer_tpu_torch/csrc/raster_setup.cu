// Triangle setup and tile binning: the rows the rasterizer reads, and the
// per-tile runs of triangle ids in draw order.
//
// Replaces no TPU kernel: the reference does both in XLA ops
// (mo_renderer_tpu/kernels/raster_setup.py triangle_setup at :122,
// bin_triangles at :339), and so did the port until these kernels, with
// ~150 elementwise torch ops for the setup and a radix sort of every
// binned_cap slot for the binning.
//
// What bounds it on this card: launches and latency, not bytes.  A frame's
// setup reads ~36 bytes and writes 80 bytes a triangle (52K triangles:
// ~6 MB, ~2 us at 3.35 TB/s) and its binning touches ~55K pairs a few
// times; the torch version took ~0.5 ms, in ~190 launches and a sort
// whose length is the static capacity, not the pairs.
//
// Design, four launches a tiling:
//   tri_setup_kernel  one thread a triangle: the corners (given, gathered
//                     through the indices, or the packed world corners
//                     through the (4, 4) matrix, fused in), the 16-float
//                     row and the inclusive pixel box, in vector stores.
//                     Every operation rounds as its torch twin does: the
//                     unit builds with -fmad=false, divisions are
//                     correctly rounded, and min / max / clamp keep
//                     torch's NaN rule, so rows and boxes equal the plain
//                     version's bit for bit.
//   bin_count_kernel  a block a chunk of kChunk triangles: each
//                     triangle's tile rectangle and pair count (the band
//                     clip, the MAX_EXACT_EXTENT box), the chunk's
//                     exclusive pair prefix, and the chunk's histogram
//                     of pairs by tile in shared memory.  The chunk's
//                     pairs are spread over its threads (slot -> triangle
//                     by a binary search of the prefix), so a triangle
//                     over many tiles costs no more than many triangles.
//   bin_scan_kernel   32 tiles a block: every chunk's offset inside each
//                     tile's run, and the tiles' totals.  Past the
//                     capacity the first triangles' pairs are kept: the
//                     chunk the capacity cuts is counted up to the cut.
//   bin_fill_kernel   a block a chunk: the tiles' starts (a scan of the
//                     totals), then the block walks the chunk's pairs in
//                     slot order, 256 at a time: equal tiles ranked by
//                     __match_any_sync within a warp and, across the
//                     step's warps, by a byte a warp of a per-tile
//                     counter; each id goes to its tile's next place.
//                     Pairs within a tile stay in draw order: chunks in
//                     order through the offsets, the slots of a chunk in
//                     order through the walk, so a triangle over
//                     thousands of tiles takes a few steps.
// Only real pairs are written; the capacity's slots past them are not
// touched.  Pair counts are 32-bit (the wrapper checks triangles x tiles).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;  // triangles a chunk: bin_count / bin_fill blocks
constexpr int kScanTiles = 32;  // tiles a bin_scan block
constexpr int kScanRows = 32;  // chunk groups a bin_scan block
constexpr unsigned kAllLanes = 0xFFFFFFFFu;
constexpr float kMaxExactExtent = 65536.0f;  // raster_setup.MAX_EXACT_EXTENT

enum Source { kCorners = 0, kIndexed = 1, kAttrs = 2 };

// torch.minimum / torch.maximum / torch.clamp on the card: a NaN operand
// is the result, else ::min / ::max
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

struct SetupArgs {
  const float* p0;  // kCorners: v0; kIndexed: clip (V, 4); kAttrs: tri_attrs
  const float* p1;  // kCorners: v1; kAttrs: the (4, 4) matrix
  const float* p2;  // kCorners: v2
  const int* idx;   // kIndexed: (T, 3)
  const unsigned char* valid;  // (T,) bool
  float4* tri_data;  // (T, 16)
  int4* bbox;        // (T, 4)
  int t, stride;     // triangles; kAttrs: the row stride of tri_attrs
  float w_eps, half_w, half_h, edge_x, edge_y, hi_x, hi_y;
  int cull, bias;
  float bias_c, bias_slope;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return make_float4(p[0], p[1], p[2], p[3]);
}

struct Edge {
  float a, b, c;
  bool tie;
};

// raster_setup.setup_from_corners' edge(): a = -s * dy, b = s * dx,
// c = s * (dy * ax - dx * ay)
__device__ __forceinline__ Edge edge(float s, float ax, float ay, float bx,
                                     float by) {
  const float dy = by - ay;
  const float dx = bx - ax;
  Edge e;
  e.a = (-s) * dy;
  e.b = s * dx;
  e.c = s * (dy * ax - dx * ay);
  e.tie = e.a > 0.0f || (e.a == 0.0f && e.b > 0.0f);
  return e;
}

template <int kSrc>
__global__ void __launch_bounds__(256) tri_setup_kernel(SetupArgs a) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.t) return;
  float4 v[3];
  if (kSrc == kCorners) {
    v[0] = load4(a.p0 + (size_t)t * 4);
    v[1] = load4(a.p1 + (size_t)t * 4);
    v[2] = load4(a.p2 + (size_t)t * 4);
  } else if (kSrc == kIndexed) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = load4(a.p0 + (size_t)a.idx[3 * (size_t)t + k] * 4);
    }
  } else {
    // raster_setup.project: (x0 m0 + x1 m1) + (x2 m2 + x3 m3), x3 = 1
    const float* row = a.p0 + (size_t)t * a.stride;
    float m[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = a.p1[i];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float x = row[3 * k], y = row[3 * k + 1], z = row[3 * k + 2];
      float c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = (x * m[4 * j] + y * m[4 * j + 1]) +
               (z * m[4 * j + 2] + m[4 * j + 3]);
      }
      v[k] = make_float4(c[0], c[1], c[2], c[3]);
    }
  }

  // to_screen: inv = 1 / (w > eps ? w : 1), as reciprocal(w) * 1.0
  float x[3], y[3], z[3];
  bool w_ok = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool ok = v[k].w > a.w_eps;
    w_ok = w_ok && ok;
    const float inv = 1.0f / (ok ? v[k].w : 1.0f);
    x[k] = (v[k].x * inv + 1.0f) * a.half_w;
    y[k] = (v[k].y * inv + 1.0f) * a.half_h;
    z[k] = v[k].z * inv;
  }
  const float area2 = (x[1] - x[0]) * (y[2] - y[0]) -
                      (y[1] - y[0]) * (x[2] - x[0]);
  const float s = area2 >= 0.0f ? 1.0f : -1.0f;
  const Edge e0 = edge(s, x[1], y[1], x[2], y[2]);
  const Edge e1 = edge(s, x[2], y[2], x[0], y[0]);
  const Edge e2 = edge(s, x[0], y[0], x[1], y[1]);
  const float abs_area = fabsf(area2);
  const float inv_area =
      abs_area > 0.0f ? 1.0f / tmax(abs_area, 1e-30f) : 0.0f;
  bool valid = a.valid[t] != 0 && w_ok && abs_area > 0.0f;
  if (a.cull) valid = valid && area2 < 0.0f;

  const float zx = (e0.a * z[0] + e1.a * z[1] + e2.a * z[2]) * inv_area;
  const float zy = (e0.b * z[0] + e1.b * z[1] + e2.b * z[2]) * inv_area;
  float zc = (e0.c * z[0] + e1.c * z[1] + e2.c * z[2]) * inv_area;
  if (a.bias) {  // shadow_pass.rs:132-140 polygon offset
    zc = (zc + a.bias_c) + a.bias_slope * tmax(fabsf(zx), fabsf(zy));
  }
  const float tie = (float)((e0.tie ? 1 : 0) + (e1.tie ? 2 : 0) +
                            (e2.tie ? 4 : 0));
  float4* out = a.tri_data + (size_t)t * 4;
  out[0] = make_float4(e0.a, e1.a, e2.a, e0.b);
  out[1] = make_float4(e1.b, e2.b, e0.c, e1.c);
  out[2] = make_float4(e2.c, zx, zy, zc);
  out[3] = make_float4(inv_area, tie, (float)t, valid ? 1.0f : 0.0f);

  const float min_x = tmin(tmin(x[0], x[1]), x[2]);
  const float max_x = tmax(tmax(x[0], x[1]), x[2]);
  const float min_y = tmin(tmin(y[0], y[1]), y[2]);
  const float max_y = tmax(tmax(y[0], y[1]), y[2]);
  int bx0 = (int)tclamp(floorf(min_x - 0.5f), 0.0f, a.hi_x);
  int bx1 = (int)tclamp(ceilf(max_x - 0.5f), 0.0f, a.hi_x);
  const int by0 = (int)tclamp(floorf(min_y - 0.5f), 0.0f, a.hi_y);
  const int by1 = (int)tclamp(ceilf(max_y - 0.5f), 0.0f, a.hi_y);
  const bool offscreen = max_x < 0.5f || min_x > a.edge_x ||
                         max_y < 0.5f || min_y > a.edge_y;
  if (offscreen || !valid) {
    bx0 = 1;
    bx1 = 0;
  }
  a.bbox[t] = make_int4(bx0, by0, bx1, by1);
}

struct BinArgs {
  const float* tri_data;
  const int4* bbox;
  int t, stride;  // triangles; tri_data's row stride (16 or more)
  int tile_h, tile_w, n_tiles_x, n_tiles;
  int band, band_row0, band_rows;
  int n_chunks;
  int cap;  // binned_cap: the slots kept
  // workspace
  int4* rect;    // (T,) tx0, listed row0, span_x, pairs
  int* lstart;   // (T,) exclusive pair prefix within the chunk
  int* ctotal;   // (n_chunks,) pairs a chunk
  int* cstart;   // (n_chunks,) the chunk's first slot in triangle order
  int* hist;     // (n_chunks, n_tiles): counts, then offsets in the runs
  int* ttotal;   // (n_tiles,) pairs a tile (kept)
  long long* totals;  // (2,) all pairs; pairs dropped by the cap
  int4* bbox_out;
};

struct FillArgs {
  const int4* rect;
  const int* lstart;
  const int* ctotal;
  const int* cstart;
  const int* offs;
  const int* ttotal;
  int t, n_tiles_x, n_tiles, n_chunks;
  int cap;  // binned_cap, pair_tri's length: a pair at or past it drops
  int* pair_tri;
  int* tile_start;
  int* tile_count;
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Exclusive scan of s[0, n) in shared memory, in place, by the whole block
// (at most 1024 threads, a multiple of 32); returns the total.  ws holds
// 32 ints of shared scratch.
__device__ int block_scan(int* s, int n, int* ws) {
  const int nt = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const int per = (n + nt - 1) / nt;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += s[i];
  int x = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAllLanes, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? ws[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kAllLanes, w, d);
      if (lane >= d) w += y;
    }
    ws[lane] = w;
  }
  __syncthreads();
  const int total = ws[n_warps - 1];
  int base = (warp ? ws[warp - 1] : 0) + x - sum;
  for (int i = lo; i < hi; ++i) {
    const int v = s[i];
    s[i] = base;
    base += v;
  }
  __syncthreads();
  return total;
}

// The triangle of a chunk that holds pair slot p: the last j with
// ls[j] <= p (ls: the chunk's exclusive pair prefix, ls[0] = 0), searched
// from ``lo``, the owner of an earlier slot.
__device__ __forceinline__ int slot_owner(const int* ls, int lo, int n,
                                          int p) {
  int hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (ls[mid] <= p) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The tile of pair ``local`` of a triangle's rectangle, row-major, as
// raster_setup._pair_key numbers it; -1 past the grid.
__device__ __forceinline__ int pair_tile(int4 r, int local, int n_tiles_x,
                                         int n_tiles) {
  const int dy = local / r.z;
  const int dx = local - dy * r.z;
  const int k = (r.y + dy) * n_tiles_x + r.x + dx;
  return k < n_tiles ? k : -1;
}

__global__ void __launch_bounds__(kChunk) bin_count_kernel(BinArgs a) {
  extern __shared__ int hist[];  // n_tiles
  __shared__ int ls[kChunk];
  __shared__ int4 rs[kChunk];
  __shared__ int ws[32];
  const int c = blockIdx.x, i = threadIdx.x;
  const int t = c * kChunk + i;
  for (int k = i; k < a.n_tiles; k += kChunk) hist[k] = 0;
  int4 r = make_int4(0, 0, 1, 0);
  if (t < a.t) {
    const float* row = a.tri_data + (size_t)t * a.stride;
    const int4 bb = a.bbox[t];
    const bool live = row[15] > 0.0f && bb.x <= bb.z;
    int4 out = bb;
    if (live) {  // a live box lies inside the target: no negative index
      const int tx0 = bb.x / a.tile_w, tx1 = bb.z / a.tile_w;
      const int ty0 = bb.y / a.tile_h, ty1 = bb.w / a.tile_h;
      int ly0 = ty0, ly1 = ty1;
      if (a.band) {
        ly0 = max(ty0, a.band_row0);
        ly1 = min(ty1, a.band_row0 + a.band_rows - 1);
      }
      const int sx = tx1 - tx0 + 1;
      r = make_int4(tx0, ly0, sx, ly1 >= ly0 ? sx * (ly1 - ly0 + 1) : 0);
      // columns 0..5 are the edges' extents in pixels (a = -+dy, b = +-dx)
      bool huge = false;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        huge = huge || !(fabsf(row[j]) <= kMaxExactExtent);
      }
      if (huge) {
        out = make_int4(tx0 * a.tile_w, ty0 * a.tile_h,
                        (tx1 + 1) * a.tile_w - 1, (ty1 + 1) * a.tile_h - 1);
      }
    }
    a.bbox_out[t] = out;
  }
  rs[i] = r;
  ls[i] = r.w;
  __syncthreads();
  const int pairs = block_scan(ls, kChunk, ws);
  if (t < a.t) {
    a.rect[t] = r;
    a.lstart[t] = ls[i];
  }
  if (i == 0) a.ctotal[c] = pairs;
  int j = 0;
  for (int p = i; p < pairs; p += kChunk) {
    j = slot_owner(ls, j, kChunk, p);
    const int k = pair_tile(rs[j], p - ls[j], a.n_tiles_x, a.n_tiles);
    if (k >= 0) atomicAdd(&hist[k], 1);
  }
  __syncthreads();
  int* out = a.hist + (size_t)c * a.n_tiles;
  for (int k = i; k < a.n_tiles; k += kChunk) out[k] = hist[k];
}

// blockDim (kScanTiles, kScanRows): threadIdx.x a tile, threadIdx.y a
// group of chunks.
__global__ void __launch_bounds__(kScanTiles * kScanRows)
bin_scan_kernel(BinArgs a) {
  __shared__ int seg[kScanTiles * kScanRows];
  __shared__ int ws[32];
  __shared__ int col[kScanRows][kScanTiles + 1];
  __shared__ int part[kScanTiles];
  __shared__ int cut[2];  // the first chunk not kept whole, its kept pairs
  const int nt = kScanTiles * kScanRows;
  const int tid = threadIdx.y * kScanTiles + threadIdx.x;

  // the chunks' first slots in triangle order (every block; cheap)
  const int per = (a.n_chunks + nt - 1) / nt;
  const int lo = min(tid * per, a.n_chunks), hi = min(lo + per, a.n_chunks);
  int sum = 0;
  for (int c = lo; c < hi; ++c) sum += a.ctotal[c];
  seg[tid] = sum;
  if (tid == 0) {
    cut[0] = a.n_chunks;
    cut[1] = 0;
  }
  if (tid < kScanTiles) part[tid] = 0;
  __syncthreads();
  const int total = block_scan(seg, nt, ws);
  int start = seg[tid];
  for (int c = lo; c < hi; ++c) {
    const int n = a.ctotal[c];
    if (blockIdx.x == 0) a.cstart[c] = start;
    if (start <= a.cap && n > a.cap - start) {  // start + n > cap, unique
      cut[0] = c;
      cut[1] = a.cap - start;
    }
    start += n;
  }
  if (blockIdx.x == 0 && tid == 0) {
    a.totals[0] = total;
    a.totals[1] = total > a.cap ? (long long)total - a.cap : 0;
  }
  __syncthreads();
  const int whole = cut[0];  // chunks [0, whole) are kept whole

  // each tile's offsets over the whole chunks, a group of chunks a row
  const int x = threadIdx.x, y = threadIdx.y;
  const int k = blockIdx.x * kScanTiles + x;
  const int len = (whole + kScanRows - 1) / kScanRows;
  const int c0 = min(y * len, whole), c1 = min(c0 + len, whole);
  int s = 0;
  if (k < a.n_tiles) {
    for (int c = c0; c < c1; ++c) s += a.hist[(size_t)c * a.n_tiles + k];
  }
  col[y][x] = s;
  __syncthreads();
  int run = 0, tot = 0;
  for (int g = 0; g < kScanRows; ++g) {
    if (g < y) run += col[g][x];
    tot += col[g][x];
  }
  if (k < a.n_tiles) {
    for (int c = c0; c < c1; ++c) {
      int* h = a.hist + (size_t)c * a.n_tiles + k;
      const int v = *h;
      *h = run;
      run += v;
    }
    if (whole < a.n_chunks && y == 0) {
      a.hist[(size_t)whole * a.n_tiles + k] = tot;
    }
  }
  // the cut chunk's first cut[1] pairs, on this block's tiles
  const int kept = cut[1];
  if (whole < a.n_chunks && kept > 0) {
    const int t0 = whole * kChunk;
    const int n = min(kChunk, a.t - t0);
    const int k0 = blockIdx.x * kScanTiles;
    int j = 0;
    for (int p = tid; p < kept; p += nt) {
      j = slot_owner(a.lstart + t0, j, n, p);
      const int kk = pair_tile(a.rect[t0 + j], p - a.lstart[t0 + j],
                               a.n_tiles_x, a.n_tiles);
      if (kk >= k0 && kk < k0 + kScanTiles) atomicAdd(&part[kk - k0], 1);
    }
  }
  __syncthreads();
  if (y == 0 && k < a.n_tiles) a.ttotal[k] = tot + part[x];
}

// The sum of the eight bytes of x (each at most 32).
__device__ __forceinline__ int byte_sum(unsigned long long x) {
  x = (x & 0x00FF00FF00FF00FFull) + ((x >> 8) & 0x00FF00FF00FF00FFull);
  x = (x & 0x0000FFFF0000FFFFull) + ((x >> 16) & 0x0000FFFF0000FFFFull);
  return (int)((x & 0xFFFFFFFFull) + (x >> 32));
}

__global__ void __launch_bounds__(kChunk) bin_fill_kernel(FillArgs a) {
  // per tile: the step's pairs by warp, a byte a warp; the next place
  extern __shared__ unsigned long long step[];  // n_tiles, then base
  int* base = (int*)(step + a.n_tiles);
  __shared__ int ls[kChunk];
  __shared__ int4 rs[kChunk];
  __shared__ int ws[32];
  const int c = blockIdx.x, i = threadIdx.x;
  const int pairs = a.ctotal[c];
  const int m = min(max(a.cap - a.cstart[c], 0), pairs);
  if (m == 0 && c != 0) return;  // the whole block
  for (int k = i; k < a.n_tiles; k += kChunk) {
    base[k] = a.ttotal[k];
    step[k] = 0;
  }
  __syncthreads();
  block_scan(base, a.n_tiles, ws);
  if (c == 0) {
    for (int k = i; k < a.n_tiles; k += kChunk) {
      const int s0 = min(base[k], a.cap);
      a.tile_start[k] = s0;
      a.tile_count[k] = min(base[k] + a.ttotal[k], a.cap) - s0;
    }
  }
  if (m == 0) return;  // the whole block
  const int* offs = a.offs + (size_t)c * a.n_tiles;
  for (int k = i; k < a.n_tiles; k += kChunk) base[k] += offs[k];
  const int t = c * kChunk + i;
  const int n = min(kChunk, a.t - c * kChunk);
  if (i < n) {
    ls[i] = a.lstart[t];
    rs[i] = a.rect[t];
  }
  __syncthreads();
  // the chunk's slots in order, kChunk at a time, a warp 32 of them: a
  // pair's place is its tile's next place, plus its tile's pairs in the
  // step's earlier warps (their bytes of step[k]), plus the equal tiles
  // of lower lanes (__match_any_sync)
  const int warp = i >> 5, lane = lane_id();
  const unsigned below = (1u << lane) - 1u;
  const unsigned long long earlier = (1ull << (8 * warp)) - 1ull;
  int j = 0;
  for (int p0 = 0; p0 < m; p0 += kChunk) {
    const int p = p0 + i;
    int k = -1;
    if (p < m) {
      j = slot_owner(ls, j, n, p);
      k = pair_tile(rs[j], p - ls[j], a.n_tiles_x, a.n_tiles);
    }
    const unsigned peers = __match_any_sync(kAllLanes, k);
    const bool leader = k >= 0 && lane == __ffs(peers) - 1;
    if (leader) {
      atomicAdd(&step[k], (unsigned long long)__popc(peers) << (8 * warp));
    }
    __syncthreads();
    int pos = 0, before = 0, all = 0;
    if (k >= 0) {
      const unsigned long long word = step[k];
      before = byte_sum(word & earlier);
      all = byte_sum(word);
      pos = base[k] + before + __popc(peers & below);
    }
    __syncthreads();
    if (leader && before == 0) {  // the tile's first warp of the step
      base[k] += all;
      step[k] = 0;
    }
    if (k >= 0 && pos < a.cap) a.pair_tri[pos] = c * kChunk + j;
    __syncthreads();
  }
}

cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// src: 0 corners (p0, p1, p2 = v0, v1, v2, each (T, 4)); 1 indexed (p0 =
// clip (V, 4), idx (T, 3) int32); 2 packed corners (p0 = tri_attrs with
// row stride ``stride``, p1 = the (4, 4) matrix).  tri_data (T, 16) f32,
// bbox (T, 4) int32.
extern "C" int mo_tri_setup(int src, const void* p0, const void* p1,
                            const void* p2, const void* idx,
                            const void* valid, void* tri_data, void* bbox,
                            int t, int stride, float w_eps, int width,
                            int height, int cull, int bias, float bias_c,
                            float bias_slope, void* stream) {
  if (t <= 0) return (int)cudaGetLastError();
  SetupArgs a;
  a.p0 = (const float*)p0;
  a.p1 = (const float*)p1;
  a.p2 = (const float*)p2;
  a.idx = (const int*)idx;
  a.valid = (const unsigned char*)valid;
  a.tri_data = (float4*)tri_data;
  a.bbox = (int4*)bbox;
  a.t = t;
  a.stride = stride;
  a.w_eps = w_eps;
  // the plain version's Python scalars, rounded to float as torch does
  a.half_w = (float)(0.5 * (double)width);
  a.half_h = (float)(0.5 * (double)height);
  a.edge_x = (float)((double)width - 0.5);
  a.edge_y = (float)((double)height - 0.5);
  a.hi_x = (float)(width - 1);
  a.hi_y = (float)(height - 1);
  a.cull = cull;
  a.bias = bias;
  a.bias_c = bias_c;
  a.bias_slope = bias_slope;
  const int threads = 256;
  const int blocks = (t + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (src == kCorners) {
    tri_setup_kernel<kCorners><<<blocks, threads, 0, s>>>(a);
  } else if (src == kIndexed) {
    tri_setup_kernel<kIndexed><<<blocks, threads, 0, s>>>(a);
  } else if (src == kAttrs) {
    tri_setup_kernel<kAttrs><<<blocks, threads, 0, s>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The counts and offsets of a binning (bin_count_kernel, bin_scan_kernel);
// ws: the int32 workspace, laid out as mo_bin_workspace_ints says.
// totals (2,) int64: all pairs, and the pairs the cap drops.
extern "C" int mo_bin_prepare(const void* tri_data, int stride,
                              const void* bbox, int t, int tile_h,
                              int tile_w, int n_tiles_x, int n_tiles,
                              int band, int band_row0, int band_rows,
                              int cap, void* ws, void* totals,
                              void* bbox_out, void* stream) {
  if (t <= 0 || n_tiles <= 0 || cap < 0) return (int)cudaErrorInvalidValue;
  BinArgs a;
  a.tri_data = (const float*)tri_data;
  a.bbox = (const int4*)bbox;
  a.t = t;
  a.stride = stride;
  a.tile_h = tile_h;
  a.tile_w = tile_w;
  a.n_tiles_x = n_tiles_x;
  a.n_tiles = n_tiles;
  a.band = band;
  a.band_row0 = band_row0;
  a.band_rows = band_rows;
  a.n_chunks = (t + kChunk - 1) / kChunk;
  a.cap = cap;
  int* w = (int*)ws;
  a.rect = (int4*)w;
  w += 4 * (size_t)t;
  a.lstart = w;
  w += t;
  a.ctotal = w;
  w += a.n_chunks;
  a.cstart = w;
  w += a.n_chunks;
  a.ttotal = w;
  w += n_tiles;
  a.hist = w;
  a.totals = (long long*)totals;
  a.bbox_out = (int4*)bbox_out;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)n_tiles * sizeof(int);
  cudaError_t e = allow_smem((const void*)bin_count_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  bin_count_kernel<<<a.n_chunks, kChunk, smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 block(kScanTiles, kScanRows);
  bin_scan_kernel<<<(n_tiles + kScanTiles - 1) / kScanTiles, block, 0, s>>>(
      a);
  return (int)cudaGetLastError();
}

// The runs: pair_tri (cap,) int32, tile_start / tile_count (n_tiles,)
// int32, from mo_bin_prepare's workspace.
extern "C" int mo_bin_fill(int t, int n_tiles_x, int n_tiles, int cap,
                           const void* ws, void* pair_tri, void* tile_start,
                           void* tile_count, void* stream) {
  if (t <= 0 || n_tiles <= 0 || cap < 0) return (int)cudaErrorInvalidValue;
  FillArgs a;
  const int n_chunks = (t + kChunk - 1) / kChunk;
  const int* w = (const int*)ws;
  a.rect = (const int4*)w;
  w += 4 * (size_t)t;
  a.lstart = w;
  w += t;
  a.ctotal = w;
  w += n_chunks;
  a.cstart = w;
  w += n_chunks;
  a.ttotal = w;
  w += n_tiles;
  a.offs = w;
  a.t = t;
  a.n_tiles_x = n_tiles_x;
  a.n_tiles = n_tiles;
  a.n_chunks = n_chunks;
  a.cap = cap;
  a.pair_tri = (int*)pair_tri;
  a.tile_start = (int*)tile_start;
  a.tile_count = (int*)tile_count;
  const size_t smem =
      (size_t)n_tiles * (sizeof(unsigned long long) + sizeof(int));
  cudaError_t e = allow_smem((const void*)bin_fill_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  bin_fill_kernel<<<n_chunks, kChunk, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Ints of mo_bin_prepare's workspace for t triangles over n_tiles tiles.
// (the wrapper checks that it fits an int)
extern "C" int mo_bin_workspace_ints(int t, int n_tiles) {
  const long long n_chunks = (t + kChunk - 1) / kChunk;
  const long long n = 5LL * t + 2 * n_chunks + n_tiles + n_chunks * n_tiles;
  return n > INT_MAX ? -1 : (int)n;
}
