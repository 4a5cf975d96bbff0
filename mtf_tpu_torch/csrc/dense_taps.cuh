// Dense-convention tap weights and samples, shared by the chain kernel
// (lk_fused_chain.cu, K1c), K6 (lk_fused_gn.cu) and the grid-flow kernel
// (grid_flow.cu, K5c), so all weigh and sum their taps exactly as the plain
// forms do (ops/kernels/dense_sample.py:_weights_dense,
// ops/interp.py:_cubic_axis); the chain kernel spells the cubic sum out.
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

// The linear dense sample at a clamped point whose 2x2 taps start at t
// (row stride `stride`), fx, fy its fractional parts: the value and its x
// and y derivatives, each 0 along an axis where the point sits exactly on
// an integer (the dense form's phi'(0) = 0).
__device__ __forceinline__ void linear_sample(const float* t, int stride,
                                              float fx, float fy, float& v,
                                              float& dx, float& dy) {
  const float v00 = t[0], v01 = t[1], v10 = t[stride], v11 = t[stride + 1];
  const float top = v00 * (1.0f - fx) + v01 * fx;
  const float bot = v10 * (1.0f - fx) + v11 * fx;
  v = top * (1.0f - fy) + bot * fy;
  dx = fx > 0.0f ? (v01 - v00) * (1.0f - fy) + (v11 - v10) * fy : 0.0f;
  dy = fy > 0.0f ? bot - top : 0.0f;
}

// The cubic dense sample from the 4x4 taps starting at t (row stride
// `stride`) with `cubic_axis` weights: each row summed first, as the dense
// contractions do.
__device__ __forceinline__ void cubic_sample(const float* t, int stride,
                                             const float (&wx)[4],
                                             const float (&dwx)[4],
                                             const float (&wy)[4],
                                             const float (&dwy)[4], float& v,
                                             float& dx, float& dy) {
  v = dx = dy = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* row = t + r * stride;
    float rs = 0.0f, rd = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float pix = row[j];
      rs += wx[j] * pix;
      rd += dwx[j] * pix;
    }
    v += wy[r] * rs;
    dx += wy[r] * rd;
    dy += dwy[r] * rs;
  }
}

}  // namespace dense_taps
