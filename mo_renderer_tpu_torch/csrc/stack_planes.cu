// Texture-stack unpack + bilinear planes for the PyTorch port's fast
// G-buffer pass.
//
// Replaces the TPU kernel mo_renderer_tpu/kernels/stack_planes.py
// stack_planes:66 (_kernel:42, pl.pallas_call at :106) -- K7 -- together
// with the texture-stack row gathers in front of it
// (passes/gbuffer.py:436).
//
// What bounds it on this card: bytes.  Per pixel it reads the stack-row
// index and the two bilinear fractions (12 bytes), one 16-byte quad per
// sampled slot (from group tables of a few MB at most, mostly L2 hits:
// neighbouring pixels sample neighbouring texels) and writes one float per
// consumed channel (up to 12); ~7 FLOPs per plane are far below the
// card's compute rate.
//
// Design: one thread per pixel.  The TPU kernel read channel-major blocks
// because that was the gather's native layout on the TPU; here the gather
// happens inside the kernel, so the (H, W, 4 * n_sampled) row tensor is
// never written.  Each sampled slot's quad is loaded once as one 16-byte
// uint4 (group rows are 4k words wide and a slot starts at a multiple of 4
// words), read as unsigned so that >> 24 brings in zeros, and only the
// channels the G-buffer reads are unpacked: ((q >> 8c) & 0xFF) * (1/255),
// blended v0*w00 + v1*w10 + v2*w01 + v3*w11 left to right.  The library
// builds with -fmad=false, so each operation rounds once like the plain
// PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxQuads = 5;  // one per material slot
constexpr int kMaxChannels = 4;

struct StackSpec {
  int n_quads;
  int group[kMaxQuads];      // which group table
  int col[kMaxQuads];        // first word of the quad in the group row
  int n_chan[kMaxQuads];     // channels unpacked from this quad
  int shift[kMaxQuads][kMaxChannels];
  int first_plane[kMaxQuads];  // its planes are consecutive from here
};

__global__ void stack_planes_kernel(
    const int* __restrict__ idx, const float* __restrict__ fx,
    const float* __restrict__ fy, const uint4* __restrict__ g0,
    const uint4* __restrict__ g1, const uint4* __restrict__ g2, int w0,
    int w1, int w2, float* __restrict__ out, int n_pix, float inv255,
    StackSpec spec) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const size_t row = (size_t)idx[p];
  const float x = fx[p];
  const float y = fy[p];
  const float w00 = (1.0f - x) * (1.0f - y);
  const float w10 = x * (1.0f - y);
  const float w01 = (1.0f - x) * y;
  const float w11 = x * y;
  const size_t plane = (size_t)n_pix;
#pragma unroll
  for (int i = 0; i < kMaxQuads; ++i) {
    if (i >= spec.n_quads) break;
    const int g = spec.group[i];
    const uint4* table = g == 0 ? g0 : (g == 1 ? g1 : g2);
    const int wq = g == 0 ? w0 : (g == 1 ? w1 : w2);  // quads per row
    const uint4 q = table[row * wq + (spec.col[i] >> 2)];
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c >= spec.n_chan[i]) break;
      const unsigned s = (unsigned)spec.shift[i][c];
      const float v0 = (float)((q.x >> s) & 0xFFu) * inv255;
      const float v1 = (float)((q.y >> s) & 0xFFu) * inv255;
      const float v2 = (float)((q.z >> s) & 0xFFu) * inv255;
      const float v3 = (float)((q.w >> s) & 0xFFu) * inv255;
      out[plane * (spec.first_plane[i] + c) + p] =
          v0 * w00 + v1 * w10 + v2 * w01 + v3 * w11;
    }
  }
}

}  // namespace

// spec_host: host memory, n_quads rows of (group, col, n_chan, shift0..3,
// first_plane) ints.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a spec the kernel does not take.
extern "C" int mo_stack_planes(const void* idx, const void* fx, const void* fy,
                               const void* g0, const void* g1, const void* g2,
                               int w0, int w1, int w2, void* out, int n_pix,
                               float inv255, const int* spec_host,
                               int n_quads, void* stream) {
  if (n_quads < 1 || n_quads > kMaxQuads) return (int)cudaErrorInvalidValue;
  StackSpec spec;
  spec.n_quads = n_quads;
  for (int i = 0; i < n_quads; ++i) {
    const int* r = spec_host + 8 * i;
    spec.group[i] = r[0];
    spec.col[i] = r[1];
    spec.n_chan[i] = r[2];
    if (r[0] < 0 || r[0] > 2 || (r[1] & 3) != 0 || r[2] < 1 ||
        r[2] > kMaxChannels)
      return (int)cudaErrorInvalidValue;
    for (int c = 0; c < kMaxChannels; ++c) spec.shift[i][c] = r[3 + c];
    spec.first_plane[i] = r[7];
  }
  if (n_pix <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  const int blocks = (n_pix + threads - 1) / threads;
  stack_planes_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)fx, (const float*)fy, (const uint4*)g0,
      (const uint4*)g1, (const uint4*)g2, w0 >> 2, w1 >> 2, w2 >> 2,
      (float*)out, n_pix, inv255, spec);
  return (int)cudaGetLastError();
}
