// Dense-convention cubic tap weights, shared by the chain kernel
// (lk_fused_chain.cu, K1c) and the grid-flow kernel (grid_flow.cu, K5c), so
// both weigh their 4x4 taps exactly as the plain forms do
// (ops/kernels/dense_sample.py:_weights_dense, ops/interp.py:_cubic_axis).
#pragma once

#include <cuda_runtime.h>

namespace dense_taps {

// tap kinds, in the order of KINDS in ops/kernels/dense_sample.py
constexpr int kLinear = 0;
constexpr int kCubic = 1;                   // Catmull-Rom
constexpr int kBspl = 2;                    // cubic B-spline

// One cubic tap at offset t = k - x: its weight phi(t) and its derivative
// with respect to x, -phi'(t) (dense_sample.py:_weights_dense).
template <int kKind>
__device__ __forceinline__ void cubic_tap(float t, float& w, float& d) {
  const float a = fabsf(t);
  const float s = t > 0.0f ? 1.0f : (t < 0.0f ? -1.0f : 0.0f);
  const float a2 = a * a, a3 = a * a * a;
  float w_in, w_out, d_in, d_out;
  if constexpr (kKind == kCubic) {
    w_in = 1.5f * a3 - 2.5f * a2 + 1.0f;
    w_out = -0.5f * a3 + 2.5f * a2 - 4.0f * a + 2.0f;
    d_in = 4.5f * a2 - 5.0f * a;
    d_out = -1.5f * a2 + 5.0f * a - 4.0f;
  } else {
    const float u = a - 2.0f;
    w_in = 0.5f * a3 - a2 + 2.0f / 3.0f;
    w_out = -(u * u * u) / 6.0f;
    d_in = 1.5f * a2 - 2.0f * a;
    d_out = -0.5f * (u * u);
  }
  w = a < 1.0f ? w_in : (a < 2.0f ? w_out : 0.0f);
  d = -((a < 1.0f ? d_in : (a < 2.0f ? d_out : 0.0f)) * s);
}

// The 4 cubic taps along one axis of a clamped coordinate x, starting at
// floor(x) - 1; t = k - x is exact in float32, as in the dense form.
template <int kKind>
__device__ __forceinline__ void cubic_axis(float x, float (&w)[4],
                                           float (&d)[4]) {
  const float f = floorf(x);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    cubic_tap<kKind>((f + (float)(j - 1)) - x, w[j], d[j]);
}

}  // namespace dense_taps
