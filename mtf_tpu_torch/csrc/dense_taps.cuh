// Dense-convention tap weights and samples, shared by the chain kernel
// (lk_fused_chain.cu, K1c), K6 (lk_fused_gn.cu) and the grid-flow kernel
// (grid_flow.cu, K5c), so all weigh and sum their taps exactly as the plain
// forms do (ops/kernels/dense_sample.py:_weights_dense,
// ops/interp.py:_cubic_axis); the chain kernel spells the cubic sum out.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dense_taps {

// tap kinds, in the order of KINDS in ops/kernels/dense_sample.py
constexpr int kLinear = 0;
constexpr int kCubic = 1;                   // Catmull-Rom
constexpr int kBspl = 2;                    // cubic B-spline

// A tap or derivative weight as the bfloat16-operand flag (`interp_bf16`,
// a separate build of each kernel) takes it: rounded to bfloat16, to
// nearest even (what torch's `.to(torch.bfloat16)` does in the plain
// forms), with kBf16; every product and sum stays float32.
template <bool kBf16>
__device__ __forceinline__ float tap_weight(float w) {
  if constexpr (kBf16)
    return __bfloat162float(__float2bfloat16_rn(w));
  else
    return w;
}

// One cubic tap at offset t = k - x: its weight phi(t) and its derivative
// with respect to x, -phi'(t) (dense_sample.py:_weights_dense). With kRn
// every product and sum is rounded on its own in the plain form's order
// (torch's elementwise ops; no FMA contraction), so the weight is the
// plain form's bit for bit: the bfloat16 flag's rounding would turn a
// float32 ulp of difference into a bfloat16 one.
template <int kKind, bool kRn = false>
__device__ __forceinline__ void cubic_tap(float t, float& w, float& d) {
  const float a = fabsf(t);
  const float s = t > 0.0f ? 1.0f : (t < 0.0f ? -1.0f : 0.0f);
  float w_in, w_out, d_in, d_out;
  if constexpr (kRn) {
    const float a2 = __fmul_rn(a, a), a3 = __fmul_rn(a2, a);
    if constexpr (kKind == kCubic) {
      w_in = __fadd_rn(__fsub_rn(__fmul_rn(1.5f, a3), __fmul_rn(2.5f, a2)),
                       1.0f);
      w_out = __fadd_rn(__fsub_rn(__fadd_rn(__fmul_rn(-0.5f, a3),
                                            __fmul_rn(2.5f, a2)),
                                  __fmul_rn(4.0f, a)), 2.0f);
      d_in = __fsub_rn(__fmul_rn(4.5f, a2), __fmul_rn(5.0f, a));
      d_out = __fsub_rn(__fadd_rn(__fmul_rn(-1.5f, a2), __fmul_rn(5.0f, a)),
                        4.0f);
    } else {
      const float u = __fsub_rn(a, 2.0f), u2 = __fmul_rn(u, u);
      w_in = __fadd_rn(__fsub_rn(__fmul_rn(0.5f, a3), a2), 2.0f / 3.0f);
      w_out = __fmul_rn(-__fmul_rn(u2, u), 1.0f / 6.0f);
      d_in = __fsub_rn(__fmul_rn(1.5f, a2), __fmul_rn(2.0f, a));
      d_out = __fmul_rn(-0.5f, u2);
    }
  } else {
    const float a2 = a * a, a3 = a * a * a;
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
  }
  w = a < 1.0f ? w_in : (a < 2.0f ? w_out : 0.0f);
  d = -((a < 1.0f ? d_in : (a < 2.0f ? d_out : 0.0f)) * s);
}

// The 4 cubic taps along one axis of a clamped coordinate x, starting at
// floor(x) - 1; t = k - x is exact in float32, as in the dense form. With
// kBf16 each weight and derivative is the plain form's (`cubic_tap` with
// kRn), rounded to bfloat16 (`tap_weight`).
template <int kKind, bool kBf16 = false>
__device__ __forceinline__ void cubic_axis(float x, float (&w)[4],
                                           float (&d)[4]) {
  const float f = floorf(x);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    cubic_tap<kKind, kBf16>((f + (float)(j - 1)) - x, w[j], d[j]);
    w[j] = tap_weight<kBf16>(w[j]);
    d[j] = tap_weight<kBf16>(d[j]);
  }
}

// The linear dense sample from the 2x2 taps v00, v01 (row y), v10, v11
// (row y + 1) of a clamped point with fractional parts fx, fy, under the
// bfloat16 flag: the value and its x and y derivatives, each 0 along an
// axis where the point sits exactly on an integer (the dense form's
// phi'(0) = 0). The weights 1 - f and f are rounded (`tap_weight`); the
// derivative weights -1 and 1 are exact in bfloat16.
template <bool kBf16>
__device__ __forceinline__ void linear_taps(float v00, float v01, float v10,
                                            float v11, float fx, float fy,
                                            float& v, float& dx, float& dy) {
  const float wx0 = tap_weight<kBf16>(1.0f - fx);
  const float wx1 = tap_weight<kBf16>(fx);
  const float wy0 = tap_weight<kBf16>(1.0f - fy);
  const float wy1 = tap_weight<kBf16>(fy);
  const float top = v00 * wx0 + v01 * wx1;
  const float bot = v10 * wx0 + v11 * wx1;
  v = top * wy0 + bot * wy1;
  dx = fx > 0.0f ? (v01 - v00) * wy0 + (v11 - v10) * wy1 : 0.0f;
  dy = fy > 0.0f ? bot - top : 0.0f;
}

// The linear dense sample at a clamped point whose 2x2 taps start at t
// (row stride `stride`): `linear_taps` with kBf16; without it the same
// sums spelled out as before the flag existed, so the unflagged builds
// compile as they did (their registers, `chip_smoke.REGS_S8`).
template <bool kBf16 = false>
__device__ __forceinline__ void linear_sample(const float* t, int stride,
                                              float fx, float fy, float& v,
                                              float& dx, float& dy) {
  if constexpr (kBf16) {
    linear_taps<true>(t[0], t[1], t[stride], t[stride + 1], fx, fy, v, dx,
                      dy);
  } else {
    const float v00 = t[0], v01 = t[1], v10 = t[stride], v11 = t[stride + 1];
    const float top = v00 * (1.0f - fx) + v01 * fx;
    const float bot = v10 * (1.0f - fx) + v11 * fx;
    v = top * (1.0f - fy) + bot * fy;
    dx = fx > 0.0f ? (v01 - v00) * (1.0f - fy) + (v11 - v10) * fy : 0.0f;
    dy = fy > 0.0f ? bot - top : 0.0f;
  }
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
