// Raster megakernel: visibility plus the winner's perspective-correct
// attribute planes, for raster_interp_attrs=True.
//
// Replaces the TPU kernel K8 of mo_renderer_tpu/kernels/rasterizer.py:
//   rasterize_attrs:288 (_make_attrs_kernel:210, _process_rows_attrs:141),
// reaching pl.pallas_call at rasterizer.py:336.
//
// The TPU kernel interpolates all 14 channels for every candidate row and
// keeps the winner's with a one-hot sum.  Here the walk only finds each
// pixel's winner; the winner's attributes are interpolated once, after it.
//
// What bounds it on this card: bytes.  It writes depth, id and 16 planes
// (18 x 4 bytes a pixel, 150 MB at 1088 x 1920) and reads a few MB of
// rows; the arithmetic is ~100 FP32 operations a covered pixel.
//
// Design:
// - The walk is the region walk of raster_common.cuh, shared with
//   raster.cu in its slim mode: one 512-thread block per 32 x 32 region,
//   box cull by region and by warp, cp.async double buffer.  Only the 16
//   raster columns are staged.  So a dense scene costs what it costs the
//   visibility raster, and 4 blocks a bin tile (2040 at 1080p) overlap one
//   region's walk with another's stores.
// - Inputs come as two aligned tensors: the (T, 16) raster rows and the
//   (T, 48) attribute rows (vertex_stage.pack_raster_attr_rows: per-corner
//   1/w, 14 channels x 3 corners channel-major, material id, has_tangent,
//   one pad column).  After the walk a thread reads its winner's rows as
//   four + twelve 16-byte loads a pixel (the raster row, then the
//   attribute row); a region's pixels share few winners, so these hit
//   L1/L2.
// - 2 pixels a thread, a lane per column: each of the 18 output streams is
//   a 128-byte row per warp-wide store.  The 16 planes leave
//   with streaming stores (__stcs), so 134 MB of output do not push the
//   rows out of L2 (0.0639 -> 0.0569 ms on a 1.1K-triangle scene at 1080p,
//   H100; writing zeros without any walk reads 0.0533 ms).
//
// Arithmetic, identical to the plain version in kernels/rasterizer.py:
//   w_i = fma(a_i, px, b_i*py) + c_i      (the reference's CPU form)
//   bb_i = w_i * inv_area,  q_i = bb_i * iw_i,  qs = (q0 + q1) + q2
//   rs = 1 / (|qs| > 1e-20 ? qs : 1),   ob_i = q_i * rs
//   v = (ob0 * a0 + ob1 * a1) + ob2 * a2  per channel, one rounding per op.
// Outputs: z, tri (int32, -1 where z >= 1) and 16 planes (14 channels,
// material id, has_tangent); zeros where no triangle won.
#include "raster_common.cuh"

namespace {

using namespace raster_common;

constexpr int kNInterp = 14;
constexpr int kNPlanes = kNInterp + 2;
constexpr int kAttrRow = 48;  // 3 + 3 * 14 + 2 columns and one of padding
constexpr int kColAttr = 3;   // the first channel's first corner

__global__ void __launch_bounds__(kThreads)
raster_attrs_kernel(const float* __restrict__ tri_data,
                    const float4* __restrict__ attr_rows,
                    const int4* __restrict__ boxes,
                    const int* __restrict__ pair_tri,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ tile_count,
                    float* __restrict__ z_out, int* __restrict__ tri_out,
                    float* __restrict__ planes, int width, int height,
                    int n_tiles_x) {
  const Place at = place_of_thread(n_tiles_x);
  if (at.rx0 >= width || at.ry0 >= height) return;  // the whole block
  const Winners<kSlim> win = walk_region<kSlim>(
      at, tri_data, boxes, pair_tri, tile_start, tile_count);

  if (at.x >= width) return;
  const float px = (float)at.x + 0.5f;
  const size_t plane_stride = (size_t)width * height;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int y = at.ry0 + at.wy0 + k;
    if (y >= height) break;
    const size_t o = (size_t)y * width + at.x;
    const int id = win.id[k];
    z_out[o] = win.z[k];
    tri_out[o] = win.z[k] < 1.0f ? id : -1;
    float out[kNPlanes];
    if (id < 0) {
#pragma unroll
      for (int c = 0; c < kNPlanes; ++c) out[c] = 0.0f;
    } else {
      // a0 a1 a2 b0 | b1 b2 c0 c1 | c2 .. | inv_area ..
      const float4* R =
          reinterpret_cast<const float4*>(tri_data + (size_t)id * kRow);
      const float4 A = R[0];
      const float4 B = R[1];
      const float c2 = R[2].x;
      const float inv_area = R[3].x;
      float e[kAttrRow];
      const float4* E = attr_rows + (size_t)id * (kAttrRow / 4);
#pragma unroll
      for (int i = 0; i < kAttrRow / 4; ++i) {
        const float4 v = E[i];
        e[4 * i] = v.x;
        e[4 * i + 1] = v.y;
        e[4 * i + 2] = v.z;
        e[4 * i + 3] = v.w;
      }
      const float py = (float)y + 0.5f;
      const float q0 = __fmul_rn(
          __fmul_rn(fused_plane(A.x, A.w, B.z, px, py), inv_area), e[0]);
      const float q1 = __fmul_rn(
          __fmul_rn(fused_plane(A.y, B.x, B.w, px, py), inv_area), e[1]);
      const float q2 = __fmul_rn(
          __fmul_rn(fused_plane(A.z, B.y, c2, px, py), inv_area), e[2]);
      const float qs = __fadd_rn(__fadd_rn(q0, q1), q2);
      const float rs = __frcp_rn(fabsf(qs) > 1e-20f ? qs : 1.0f);
      const float ob0 = __fmul_rn(q0, rs);
      const float ob1 = __fmul_rn(q1, rs);
      const float ob2 = __fmul_rn(q2, rs);
#pragma unroll
      for (int c = 0; c < kNInterp; ++c) {
        const float* a = e + kColAttr + 3 * c;
        out[c] = __fadd_rn(
            __fadd_rn(__fmul_rn(ob0, a[0]), __fmul_rn(ob1, a[1])),
            __fmul_rn(ob2, a[2]));
      }
      out[kNInterp] = e[kColAttr + 3 * kNInterp];
      out[kNInterp + 1] = e[kColAttr + 3 * kNInterp + 1];
    }
#pragma unroll
    for (int c = 0; c < kNPlanes; ++c) {
      __stcs(planes + c * plane_stride + o, out[c]);
    }
  }
}

}  // namespace

// tri_data rows are 16 floats, attr_rows 48 floats, boxes 4 ints (x0, y0,
// x1, y1 inclusive), all 16-byte aligned.
extern "C" int mo_raster_attrs(const void* tri_data, const void* attr_rows,
                               const void* boxes, const void* pair_tri,
                               const void* tile_start, const void* tile_count,
                               void* z_out, void* tri_out, void* planes,
                               int width, int height, int n_tiles_x,
                               int n_tiles_y, void* stream) {
  const int n_tiles = n_tiles_x * n_tiles_y;
  if (n_tiles <= 0) return (int)cudaGetLastError();
  raster_attrs_kernel<<<n_tiles * kRegionsPerTile, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)tri_data, (const float4*)attr_rows, (const int4*)boxes,
      (const int*)pair_tri, (const int*)tile_start, (const int*)tile_count,
      (float*)z_out, (int*)tri_out, (float*)planes, width, height,
      n_tiles_x);
  return (int)cudaGetLastError();
}
