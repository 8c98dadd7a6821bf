// Radius-quantized SSAO tile kernel for the PyTorch port's frames.
//
// Replaces the TPU kernel mo_renderer_tpu/passes/ssao.py ssao_pass_pallas:171
// (kernel body :225, pl.pallas_call at :275) -- K4 -- including the
// linearisation and edge padding its wrapper does in front of the call.
//
// What bounds it on this card: arithmetic rate and latency, not memory.
// Per pixel it compares 18 taps (an IEEE square root only for a tap that
// occludes: one special-function operation and its FP32 fix-up), does
// two IEEE divisions and one double-precision sin for the hash noise, and
// reads 1 + 18 window values and 18 table offsets from shared memory; the
// input plane is read about twice (the halo) and the output written once,
// ~5 MB at the default 1080p frame's 576 x 1024 half-resolution grid.
// The whole grid is one wave of blocks, so every block fills its window
// at the same time and nothing overlaps that phase but the fill itself.
//
// Design:
// - One block of 512 threads per 32 x 32 output tile, two pixels a thread:
//   the fastest of the fourteen shapes timed on an H100 (16..64 rows, 32
//   or 64 columns, 128..1024 threads).  More, smaller blocks balance the
//   132 SMs better and more threads a tile hide more latency, but a
//   smaller tile linearizes more halo per output.  passes/ssao.py builds
//   the window offsets for this tile width (TILE_W there).
// - Every table lives in shared memory: the block copies the per-(level,
//   tap) offsets INSIDE THE WINDOW (oy * window width + ox, built once on
//   the host), the tap fades and the level edges, so the tap loop reads no
//   global memory.  Levels are 18 words apart, so the 16 levels of one tap
//   fall into different banks: lanes on different levels do not collide
//   on the offset read, which takes two taps at a time (8 bytes).
// - The block fills a window of LINEAR depth with a halo of max |tap
//   offset| pixels, clamping coordinates to the image exactly like the
//   reference's edge padding.  A thread starts four loads before it
//   divides and stores, and the table loads before all of them: the fill
//   is a few round trips to L2, not one per element.  The halo (21 at
//   width 1024) makes the window's first column odd, so elements are
//   loaded 4 bytes at a time: no 16-byte alignment to use.
// - Per pixel: hash noise from the global pixel coordinate, the radius
//   level by a branch-free binary search over the sorted edges (padded
//   with +inf to a power of two), then its level's 18 taps, unrolled, in
//   tap order; a tap that does not occlude ends at one compare.  Only the
//   pixel's own level is evaluated (the TPU kernel evaluated all 16 and
//   selected).
//
// The band form (K4b: ssao_pass_pallas(row_offset, y_halo=(top, bottom)),
// ssao.py:176-177, :210-219, the row-sharded frame's SSAO) takes the rows
// above and below the band from two more planes of raw depth, halo_rows
// rows each, instead of clamping at the band's edge: the window's rows run
// from -halo_rows to h + halo_rows - 1, clamped there, and each comes from
// the top plane, the band or the bottom plane.  Two pointers, not one
// taller plane: a taller plane is a copy of the whole band before every
// launch (an extra read and write of it and a launch), while the choice of
// pointer costs the fill a select per element, in the band form only
// (kHalo false compiles to the whole-image kernel as it was).
//
// Arithmetic, unchanged: multiply-adds are fused (fmaf) at exactly the
// three places where the reference's CPU evaluation fuses them, and its
// divisions by constants are multiplies by float32 reciprocals as XLA folds
// them; everything else rounds once per operation (-fmad=false).  The
// noise's sin runs in double and is rounded once, so it does not depend on
// any one f32 sin implementation (its ~1e5-radian argument makes the hash
// sensitive to the last ulp).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 18;  // passes/ssao.py: rings of 6 and 12 samples
constexpr int kTileH = 32;  // output tile rows
constexpr int kTileW = 32;  // output tile columns: passes/ssao.py TILE_W
constexpr int kThreads = 512;

constexpr int kMaxLevels = 32;
constexpr int kFillBatch = 4;  // window loads a thread keeps in flight

struct Params {
  int h, w, halo, levels, search;  // search: power of two >= levels
  float c2n, cfpn, cfmn, inv_w, half_w, inv_krange, inv_total, inv_255;
  int row_offset;
  int halo_rows;  // rows of each halo plane (band form)
};

template <bool kHalo>
__global__ void __launch_bounds__(kThreads)
ssao_kernel(const float* __restrict__ depth, const float* __restrict__ top,
            const float* __restrict__ bottom, float* __restrict__ out,
            const int* __restrict__ win_offs, const float* __restrict__ fades,
            const float* __restrict__ edges, Params p) {
  static_assert((kTileH * kTileW) % kThreads == 0 && kThreads % 32 == 0,
                "tile shape");
  static_assert(kTileH % 2 == 0 && kTileW % 2 == 0, "8-byte aligned tables");
  extern __shared__ float smem[];
  const int ww = kTileW + 2 * p.halo;
  const int wh = kTileH + 2 * p.halo;
  float* win = smem;
  int* s_off = reinterpret_cast<int*>(win + wh * ww);  // levels x kTaps
  float* s_fade = reinterpret_cast<float*>(s_off + p.levels * kTaps);
  float* s_edge = s_fade + kTaps;  // search - 1 sorted edges, +inf padded
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;

  // The tables' loads go out first and are stored after the fill, so
  // their latency hides behind the window's.
  constexpr int kOffRegs = (kMaxLevels * kTaps + kThreads - 1) / kThreads;
  const int n_off = p.levels * kTaps;
  int off_reg[kOffRegs];
#pragma unroll
  for (int u = 0; u < kOffRegs; ++u) {
    const int i = threadIdx.x + u * kThreads;
    off_reg[u] = i < n_off ? win_offs[i] : 0;
  }
  // one more table word a thread: the fades, then the padded edges
  float misc = CUDART_INF_F;
  if (threadIdx.x < kTaps) {
    misc = fades[threadIdx.x];
  } else if (threadIdx.x - kTaps < p.levels - 1) {
    misc = edges[threadIdx.x - kTaps];
  }

  // The window, kFillBatch elements a thread at a time: all loads of a
  // batch first, then the divisions and the stores.  Row and column of a
  // flat index come from a float reciprocal (its error at these sizes,
  // a few hundred rows and columns, is far below half a column; the
  // fix-up covers a miss by one all the same).
  const int total = wh * ww;
  const float inv_ww = 1.0f / (float)ww;
  auto load_batch = [&](int base, float (&d)[kFillBatch]) {
#pragma unroll
    for (int u = 0; u < kFillBatch; ++u) {
      const int i = base + u * kThreads;
      d[u] = 0.0f;
      if (i < total) {
        int r = (int)(((float)i + 0.5f) * inv_ww);
        int c = i - r * ww;
        if (c < 0) {
          c += ww;
          r -= 1;
        } else if (c >= ww) {
          c -= ww;
          r += 1;
        }
        const int gx = min(max(x0 - p.halo + c, 0), p.w - 1);
        if (kHalo) {
          const int gy =
              min(max(y0 - p.halo + r, -p.halo_rows), p.h + p.halo_rows - 1);
          const float* row =
              gy < 0      ? top + (size_t)(gy + p.halo_rows) * p.w
              : gy >= p.h ? bottom + (size_t)(gy - p.h) * p.w
                          : depth + (size_t)gy * p.w;
          d[u] = row[gx];
        } else {
          const int gy = min(max(y0 - p.halo + r, 0), p.h - 1);
          d[u] = depth[(size_t)gy * p.w + gx];
        }
      }
    }
  };
  auto store_batch = [&](int base, const float (&d)[kFillBatch]) {
#pragma unroll
    for (int u = 0; u < kFillBatch; ++u) {
      const int i = base + u * kThreads;
      if (i < total) win[i] = p.c2n / fmaf(-d[u], p.cfmn, p.cfpn);
    }
  };

  for (int base = threadIdx.x; base < total; base += kThreads * kFillBatch) {
    float d[kFillBatch];
    load_batch(base, d);
    store_batch(base, d);
  }
#pragma unroll
  for (int u = 0; u < kOffRegs; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < n_off) s_off[i] = off_reg[u];
  }
  // s_fade and s_edge are contiguous: kTaps fades, then search - 1 edges
  if (threadIdx.x < kTaps + p.search - 1) s_fade[threadIdx.x] = misc;
  __syncthreads();

#pragma unroll 1
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int ly = i / kTileW;
    const int lx = i - ly * kTileW;
    const int y = y0 + ly;
    const int x = x0 + lx;
    if (y >= p.h || x >= p.w) continue;
    const float* center = win + (ly + p.halo) * ww + (lx + p.halo);
    const float dd = center[0];
    const float dc = fminf(fmaxf(dd, 0.05f), 1.0f);

    const float pxf = (float)x;
    const float pyf = (float)(y + p.row_offset);
    const float arg = fmaf(pxf, 12.9898f, pyf * 78.233f);
    const float v = (float)sin((double)arg) * 43758.5453f;
    const float nx = (v - floorf(v)) * 0.004f;
    const float rw = fmaf(nx, 1.0f - nx, p.inv_w / dc) * p.half_w;
    // the number of edges below rw
    int lvl = 0;
    for (int step = p.search >> 1; step > 0; step >>= 1) {
      lvl += rw > s_edge[lvl + step - 1] ? step : 0;
    }

    // One tap: ssao.comp's compareDepths times the tap's fade,
    //   min(0.5, max(0, dz - 0.001) * 50) * sqrt(clamp(1 - dz * inv_krange,
    //   0, 1)) * fade,   dz = d_centre - d_tap.
    // The first factor is 0 unless dz > 0.001 (a float difference is 0
    // only between equal numbers), and then the term is +0 and adding it
    // changes nothing: most taps of most pixels end at the compare.  The
    // saturate modifier is the clamp to [0, 1].
    const int2* o = reinterpret_cast<const int2*>(s_off + lvl * kTaps);
    float ao = 0.0f;
#pragma unroll
    for (int t2 = 0; t2 < kTaps / 2; ++t2) {
      const int2 step = o[t2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = 2 * t2 + half;
        const float dz = dd - center[half == 0 ? step.x : step.y];
        if (dz > 0.001f) {
          const float c =
              fminf(0.5f, fmaxf(0.0f, dz - 0.001f) * 50.0f) *
              sqrtf(__saturatef(1.0f - dz * p.inv_krange)) * s_fade[t];
          ao = ao + c;
        }
      }
    }
    ao = 1.0f - ao * p.inv_total;
    out[(size_t)y * p.w + x] =
        rintf(fminf(fmaxf(ao, 0.0f), 1.0f) * 255.0f) * p.inv_255;
  }
}

template <bool kHalo>
int launch(const float* depth, const float* top, const float* bottom,
           float* out, const int* win_offs, const float* fades,
           const float* edges, const Params& p, cudaStream_t s) {
  const size_t smem =
      ((size_t)(kTileH + 2 * p.halo) * (size_t)(kTileW + 2 * p.halo) +
       (size_t)p.levels * kTaps + kTaps + p.search) *
      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssao_kernel<kHalo>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((p.w + kTileW - 1) / kTileW, (p.h + kTileH - 1) / kTileH);
  ssao_kernel<kHalo><<<grid, kThreads, smem, s>>>(depth, top, bottom, out,
                                                  win_offs, fades, edges, p);
  return (int)cudaGetLastError();
}

int make_params(int h, int w, int halo, int levels, int ntaps, float c2n,
                float cfpn, float cfmn, float inv_w, float half_w,
                float inv_krange, float inv_total, float inv_255,
                int row_offset, int halo_rows, Params* p) {
  if (ntaps != kTaps || levels < 1 || levels > kMaxLevels) {
    return (int)cudaErrorInvalidValue;
  }
  int search = 1;
  while (search < levels) search <<= 1;
  *p = {h,      w,          halo,      levels,  search,     c2n,
        cfpn,   cfmn,       inv_w,     half_w,  inv_krange, inv_total,
        inv_255, row_offset, halo_rows};
  return 0;
}

}  // namespace

// win_offs: (levels, 18) offsets inside a window that is 32 + 2 * halo
// wide.  ntaps must be 18 and levels at most 32: anything else is refused
// with cudaErrorInvalidValue.
extern "C" int mo_ssao(const void* depth, void* out, const void* win_offs,
                       const void* fades, const void* edges, int h, int w,
                       int halo, int levels, int ntaps, float c2n, float cfpn,
                       float cfmn, float inv_w, float half_w,
                       float inv_krange, float inv_total, float inv_255,
                       int row_offset, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaGetLastError();
  Params p;
  const int bad = make_params(h, w, halo, levels, ntaps, c2n, cfpn, cfmn,
                              inv_w, half_w, inv_krange, inv_total, inv_255,
                              row_offset, 0, &p);
  if (bad) return bad;
  return launch<false>((const float*)depth, nullptr, nullptr, (float*)out,
                       (const int*)win_offs, (const float*)fades,
                       (const float*)edges, p, (cudaStream_t)stream);
}

// The band form: top and bottom are (halo_rows, w) planes of raw
// depth above and below the (h, w) band; halo_rows must be at least halo.
extern "C" int mo_ssao_halo(const void* depth, const void* top,
                            const void* bottom, void* out,
                            const void* win_offs, const void* fades,
                            const void* edges, int h, int w, int halo,
                            int levels, int ntaps, float c2n, float cfpn,
                            float cfmn, float inv_w, float half_w,
                            float inv_krange, float inv_total, float inv_255,
                            int row_offset, int halo_rows, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaGetLastError();
  if (halo_rows < halo) return (int)cudaErrorInvalidValue;
  Params p;
  const int bad = make_params(h, w, halo, levels, ntaps, c2n, cfpn, cfmn,
                              inv_w, half_w, inv_krange, inv_total, inv_255,
                              row_offset, halo_rows, &p);
  if (bad) return bad;
  return launch<true>((const float*)depth, (const float*)top,
                      (const float*)bottom, (float*)out, (const int*)win_offs,
                      (const float*)fades, (const float*)edges, p,
                      (cudaStream_t)stream);
}
