// Checkerboard reconstruct-and-interleave for the PyTorch port's
// checkerboard frames, with the present pass's quantisation fused in.
//
// Replaces the TPU kernel mo_renderer_tpu/kernels/decimate.py
// interleave_cols_pallas:98 (pl.pallas_call at :121) -- K5 -- whose only
// caller is passes/checkerboard.py reconstruct_full:54; the neighbour fill
// of reconstruct_full (:61-95) is fused in, and the second entry also takes
// in passes/present.py present_pass:13 (nine small PyTorch launches).
//
// What bounds it on this card: bytes in principle (per output pixel pair
// 4 or 12 bytes of the shaded cb pixel and 8 of triangle ids read, 8
// written: 21 or 29 MB at the 1088 x 1920 frame, no meaningful arithmetic),
// in practice the number of memory transactions, their latency and the
// fill's arithmetic: the kernel is over in ~10 us, half of which an empty
// kernel takes between two events.
//
// Design:
// - A warp owns a strip of 64 pixel pairs x kR rows.  A thread owns two
//   neighbouring pairs (y, 2p), (y, 2p + 1) of every row: it reads each row
//   once, the cb pixels as 8 bytes (or the float colour as 24) and the four
//   triangle ids as 16, and keeps the kR + 2 rows (one halo row above and
//   below) in registers.  All loads are started before the first use, so the
//   memory latency is paid once.  Up and down neighbours are then registers,
//   the side neighbour of the outer pair comes from the next lane by
//   shuffle; only a strip's first or last lane loads it.  Each row's four
//   output pixels leave as one 16-byte store.  An input byte comes from
//   device memory once and from L2 (kR + 2) / kR times.
// - The kernel is templated on its source.  The packed source reads rgba8
//   words (reconstruct_full); the colour source reads the shaded (H, Wc, 3)
//   float colour and quantises it as present_pass does: clamp to [0, 1],
//   one rounding for x255, round half to even, alpha 0xFF.  A NaN channel
//   becomes 0 here (fminf/fmaxf drop it) where torch.clamp passes it on;
//   frames are finite.
// - 8- and 16-byte accesses need an even plane width and aligned bases;
//   any other plane takes the same kernel with element-wise accesses.
//
// The fill averages 8-bit channel values with 0/1 weights, which is exact
// in float32, so the kernel equals the plain PyTorch version bit for bit
// (rintf rounds half to even like torch.round).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// rows of a warp's strip: on an H100 at 1088 x 960 pairs, 4 rows read
// 0.0106 ms (packed) / 0.0131 ms (colour), 8 rows 0.0111 / 0.0139, 2 rows
// 0.0112 / 0.0143, 16 rows 0.0123 ms; 2, 4 or 8 warps a block within 0.0005
constexpr int kR = 4;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kAllLanes = 0xffffffffu;

__device__ __forceinline__ unsigned quantize1(float v) {
  return __float2uint_rn(__fmul_rn(fminf(fmaxf(v, 0.0f), 1.0f), 255.0f));
}

__device__ __forceinline__ int quantize(float r, float g, float b) {
  return (int)(quantize1(r) | (quantize1(g) << 8) | (quantize1(b) << 16) |
               0xFF000000u);
}

// The shaded checkerboard plane as packed rgba8 words ...
struct PackedSource {
  const int* cb;
  int wc;
  __device__ __forceinline__ int at(int y, int j) const {
    return cb[(size_t)y * wc + j];
  }
  __device__ __forceinline__ int2 pair(int y, int p) const {
    return *reinterpret_cast<const int2*>(cb + (size_t)y * wc + 2 * p);
  }
};

// ... or as (H, Wc, 3) float colour, quantised on the way in.
struct ColourSource {
  const float* color;
  int wc;
  __device__ __forceinline__ int at(int y, int j) const {
    const float* c = color + ((size_t)y * wc + j) * 3;
    return quantize(c[0], c[1], c[2]);
  }
  __device__ __forceinline__ int2 pair(int y, int p) const {
    const float2* c = reinterpret_cast<const float2*>(
        color + ((size_t)y * wc + 2 * p) * 3);
    const float2 a = c[0];
    const float2 b = c[1];
    const float2 d = c[2];
    return make_int2(quantize(a.x, a.y, b.x), quantize(b.y, d.x, d.y));
  }
};

// One row as a thread holds it: the cb pixels of its two pairs and the four
// full-resolution ids under them.
struct Row {
  int c0, c1;
  int t0, t1, t2, t3;
  int odd;  // the row's parity: cb pixel (y, j) is full pixel (y, 2j + odd)
};

template <bool kVec, class Source>
__device__ __forceinline__ Row load_row(const Source& src,
                                        const int* __restrict__ tri, int y,
                                        int p, int wc) {
  Row r;
  r.odd = y & 1;
  if (kVec) {
    const int2 c = src.pair(y, p);
    const int4 t = *reinterpret_cast<const int4*>(
        tri + (size_t)y * 2 * wc + 4 * p);
    r.c0 = c.x;
    r.c1 = c.y;
    r.t0 = t.x;
    r.t1 = t.y;
    r.t2 = t.z;
    r.t3 = t.w;
  } else {
    // a plane of odd width ends on a thread with one pair: its second
    // repeats the first and is not stored
    const int j0 = 2 * p;
    const int j1 = min(2 * p + 1, wc - 1);
    const int* t = tri + (size_t)y * 2 * wc;
    r.c0 = src.at(y, j0);
    r.c1 = src.at(y, j1);
    r.t0 = t[2 * j0];
    r.t1 = t[2 * j0 + 1];
    r.t2 = t[2 * j1];
    r.t3 = t[2 * j1 + 1];
  }
  return r;
}

// The missing pixel from its four cb neighbours (left, right, up, down):
// those on the missing pixel's triangle average, or all four where none is.
// The channels are summed as integers, red and blue in the two 16-bit halves
// of one register and green in another; the mean of n <= 4 bytes times the
// float nearest 1/n rounds to the same byte as the plain version's division
// (exact for n = 1, 2, 4; for n = 3 the quotient is never near a half).
__device__ __forceinline__ int fill(int t_miss, const int (&nv)[4],
                                    const int (&nt)[4]) {
  unsigned keep[4];
  unsigned any = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    keep[k] = nt[k] == t_miss ? 0xffffffffu : 0u;
    any |= keep[k];
  }
  unsigned n = 0u, rb = 0u, g = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned m = keep[k] | ~any;
    const unsigned v = (unsigned)nv[k];
    n += m & 1u;
    rb += m & v & 0x00FF00FFu;
    g += m & (v >> 8) & 0xFFu;
  }
  const float inv =
      n == 3u ? 1.0f / 3.0f : (n == 2u ? 0.5f : (n == 4u ? 0.25f : 1.0f));
  const unsigned r8 = __float2uint_rn(__fmul_rn((float)(rb & 0xFFFFu), inv));
  const unsigned g8 = __float2uint_rn(__fmul_rn((float)g, inv));
  const unsigned b8 = __float2uint_rn(__fmul_rn((float)(rb >> 16), inv));
  return (int)(r8 | (g8 << 8) | (b8 << 16) | 0xFF000000u);
}

template <bool kVec, class Source>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
reconstruct_kernel(Source src, const int* __restrict__ tri,
                   int* __restrict__ out, int h, int wc, int strips_x) {
  const int strip = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int sy = strip / strips_x;
  const int y0 = sy * kR;
  if (y0 >= h) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int n_p = (wc + 1) / 2;  // threads that a row needs
  const int p_raw = (strip - sy * strips_x) * 32 + lane;
  // lanes past the row's end shadow its last thread and store nothing
  const int p = min(p_raw, n_p - 1);

  // the side neighbour a shuffle cannot give: the pair before the strip's
  // first on odd rows, the pair after its last on even rows
  const bool first = lane == 0;
  const bool last = lane == 31 || p_raw >= n_p - 1;

  Row rows[kR + 2];
  int side_c[kR], side_t[kR];
#pragma unroll
  for (int i = 0; i < kR + 2; ++i) {
    const int y = min(max(y0 + i - 1, 0), h - 1);
    rows[i] = load_row<kVec>(src, tri, y, p, wc);
    if (i >= 1 && i <= kR) {
      const int odd = y & 1;
      side_c[i - 1] = 0;
      side_t[i - 1] = 0;
      if (odd ? first : last) {
        const int j = odd ? max(2 * p - 1, 0) : min(2 * p + 2, wc - 1);
        side_c[i - 1] = src.at(y, j);
        side_t[i - 1] = tri[(size_t)y * 2 * wc + 2 * j + odd];
      }
    }
  }

#pragma unroll
  for (int i = 1; i <= kR; ++i) {
    const int y = y0 + i - 1;  // warp-uniform
    if (y >= h) break;
    const Row r = rows[i];
    const Row u = rows[i - 1];
    const Row d = rows[i + 1];
    const bool odd = r.odd != 0;
    // the cb ids of the thread's pairs, on this row and its neighbours
    const int ra = odd ? r.t1 : r.t0, rb = odd ? r.t3 : r.t2;
    const int ua = u.odd ? u.t1 : u.t0, ub = u.odd ? u.t3 : u.t2;
    const int da = d.odd ? d.t1 : d.t0, db = d.odd ? d.t3 : d.t2;
    // the neighbouring thread's nearer pair: before ours on odd rows,
    // after ours on even rows
    int nc = __shfl_sync(kAllLanes, odd ? r.c1 : r.c0,
                         odd ? max(lane - 1, 0) : min(lane + 1, 31));
    int nt = __shfl_sync(kAllLanes, odd ? rb : ra,
                         odd ? max(lane - 1, 0) : min(lane + 1, 31));
    if (odd ? first : last) {
      nc = side_c[i - 1];
      nt = side_t[i - 1];
    }
    // left, right, up, down of each pair's missing pixel
    const int a_val[4] = {odd ? nc : r.c0, odd ? r.c0 : r.c1, u.c0, d.c0};
    const int a_tri[4] = {odd ? nt : ra, odd ? ra : rb, ua, da};
    const int b_val[4] = {odd ? r.c0 : r.c1, odd ? r.c1 : nc, u.c1, d.c1};
    const int b_tri[4] = {odd ? ra : rb, odd ? rb : nt, ub, db};
    const int ma = fill(odd ? r.t0 : r.t1, a_val, a_tri);
    const int mb = fill(odd ? r.t2 : r.t3, b_val, b_tri);
    const int4 px = odd ? make_int4(ma, r.c0, mb, r.c1)
                        : make_int4(r.c0, ma, r.c1, mb);
    if (p_raw >= n_p) continue;
    int* o = out + (size_t)y * 2 * wc + 4 * p;
    if (kVec) {
      *reinterpret_cast<int4*>(o) = px;
    } else {
      o[0] = px.x;
      o[1] = px.y;
      if (2 * p + 1 < wc) {
        o[2] = px.z;
        o[3] = px.w;
      }
    }
  }
}

template <class Source>
int launch(Source src, const void* tri, void* out, int h, int wc,
           bool aligned, void* stream) {
  if (h <= 0 || wc <= 0) return (int)cudaGetLastError();
  const int strips_x = ((wc + 1) / 2 + 31) / 32;
  const int strips = strips_x * ((h + kR - 1) / kR);
  const int blocks = (strips + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const bool vec = aligned && wc % 2 == 0 && (uintptr_t)tri % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  if (vec) {
    reconstruct_kernel<true><<<blocks, 32 * kWarpsPerBlock, 0,
                               (cudaStream_t)stream>>>(
        src, (const int*)tri, (int*)out, h, wc, strips_x);
  } else {
    reconstruct_kernel<false><<<blocks, 32 * kWarpsPerBlock, 0,
                                (cudaStream_t)stream>>>(
        src, (const int*)tri, (int*)out, h, wc, strips_x);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// cb (h, wc) packed rgba8 words + tri (h, 2 wc) ids -> out (h, 2 wc) words
extern "C" int mo_reconstruct_interleave(const void* cb, const void* tri,
                                         void* out, int h, int wc,
                                         void* stream) {
  return launch(PackedSource{(const int*)cb, wc}, tri, out, h, wc,
                (uintptr_t)cb % 8 == 0, stream);
}

// color (h, wc, 3) float + tri (h, 2 wc) ids -> out (h, 2 wc) words
extern "C" int mo_reconstruct_present(const void* color, const void* tri,
                                      void* out, int h, int wc,
                                      void* stream) {
  return launch(ColourSource{(const float*)color, wc}, tri, out, h, wc,
                (uintptr_t)color % 8 == 0, stream);
}
