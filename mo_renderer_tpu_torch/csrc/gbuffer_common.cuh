// Device helpers of the two G-buffer kernels: csrc/gbuffer.cu (K10, the
// fast path's tail) and csrc/gbuffer_ref.cu (K12, the reference sampling
// path's gbuffer_pass).
//
// Both units build with -fmad=false and IEEE division (kernels/_build.py),
// so each operation here rounds once, as its torch op does on the card.
// The bilinear blend is not shared: K10 weighs a texture-stack quad with
// the four products of _texture_and_assemble (w00..w11), K12 blends two
// rows and then the columns as device/sampling.py _bilerp does; the two
// orders round differently.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// internal linkage in each unit that includes it
namespace {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}

// _normalize: v * rsqrt(clamp((v * v).sum(-1), min=1e-20))
__device__ __forceinline__ V3 normalize_rsqrt(V3 v) {
  const float ss = (v.x * v.x + v.y * v.y) + v.z * v.z;
  const float r = rsqrtf(ss < (float)1e-20 ? (float)1e-20 : ss);
  return v3(v.x * r, v.y * r, v.z * r);
}

// kernels/tonemap.py srgb_to_linear: the 0.04045 branch, powf(., 2.4)
__device__ __forceinline__ float srgb_to_linear(float s) {
  if (s < 0.04045f) return s * (1.0f / 12.92f);
  const float t = (s + 0.055f) * (1.0f / 1.055f);
  return powf(t < 0.0f ? 0.0f : t, 2.4f);  // torch.clamp passes a NaN on
}

// _ndc01 of a clip position (x, y, _, w): the Vulkan-flipped [0, 1] NDC
__device__ __forceinline__ void ndc01_of(float cx, float cy, float cw,
                                         float* out) {
  const float wc = fabsf(cw) > (float)1e-20 ? cw : 1.0f;
  out[0] = (cx / wc + 1.0f) * 0.5f;
  out[1] = 1.0f - (cy / wc + 1.0f) * 0.5f;
}

// channel ``s / 8`` of an RGBA8 word as unorm: the uint8 value times the
// float 1/255, as ``v.to(float32) * (1.0 / 255.0)``
__device__ __forceinline__ float unorm8(unsigned word, unsigned s,
                                        float inv255) {
  return (float)((word >> s) & 0xFFu) * inv255;
}

}  // namespace
