// Gauss-Newton gradient and normal matrix of one LK iteration from a
// precomputed warp Jacobian (K6), templated on the state size S and the tap
// kind: 6 state sizes (2, 3, 4, 5, 6, 8) x 3 kinds = 18 instantiations.
//
// Replaces the TPU kernel mtf_tpu/ops/pallas/lk_fused.py:_kernel (the
// `lk_fused_gn_t` path: _core_for -> _pallas_batched, pallas_call at
// lk_fused.py:129). It has no tracker behind it: the JAX package keeps it
// as the independent oracle of the chain kernel, fed a warp Jacobian built
// by autodiff. Contract, per tracker b:
//   inputs   win (H, W) f32 image, origin (2) the (x0, y0) of the tracker's
//            (hc, wc) window inside it (integers as floats; 0 and the
//            whole image without a crop: the crop rule is the wrapper's),
//            pts (2, N) image px, jac (2S, N) rows [Jx_0..Jx_{S-1};
//            Jy_0..Jy_{S-1}], templ (N)
//   per point  (x - x0, y - y0) clamped to [0.001, size - 1.001] (linear)
//            or [1.001, size - 2.001] (cubic kinds) of the window; val, dx,
//            dy from the dense taps (linear: the derivative along an axis is
//            0 at an exactly integer coordinate; cubic: 4x4 taps, each row
//            summed first); Jm = Jx dx + Jy dy (S), r = templ - val
//   outputs  val (N), g (S) = sum Jm r, h (S, S) = sum Jm Jm^T, float32.
// The TPU kernel's bf16 window and tap weights and its point tiling are
// layout choices, not part of the contract: everything here is float32
// and one block covers all of a tracker's points.
//
// Layout: one block per tracker, threads stride over the points, register
// accumulators for g and the upper triangle of J^T J (S + S(S+1)/2, 44 at
// S = 8), then the chain kernel's warp-shuffle + shared-memory reduction
// (no atomics, a fixed summation order). The window is read in place from
// the image at the tracker's origin (row stride W), so the crop costs no
// copy.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32): the jac rows dominate the
// bytes (8 S B per point), then points, template and val (16 B per point)
// and the window pixels the taps cover; ~40 + 2 S + S(S+1) FLOPs per point
// for linear taps. At B = 1280, N = 2500, S = 8 that is ~0.36 GB (jac
// 205 MB, 144x144 windows 106 MB, points, template and val 51 MB), ~0.11 ms;
// bytes bound every instantiation. Neighbouring threads take neighbouring
// points, so every jac row, the points, the template and val are read
// and written coalesced.

#include <cuda_runtime.h>
#include <stddef.h>

#include "dense_taps.cuh"

namespace {

using dense_taps::cubic_axis;
using dense_taps::cubic_sample;
using dense_taps::kBspl;
using dense_taps::kCubic;
using dense_taps::kLinear;
using dense_taps::linear_sample;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int kS, int kKind>
__global__ void __launch_bounds__(kThreads)
lk_fused_gn_kernel(const float* __restrict__ win,
                   const float* __restrict__ origin,
                   const float* __restrict__ pts,
                   const float* __restrict__ jac,
                   const float* __restrict__ templ,
                   float* __restrict__ val, float* __restrict__ g_out,
                   float* __restrict__ h_out, int h, int w, int hc, int wc,
                   int n) {
  constexpr int kNH = kS * (kS + 1) / 2;
  constexpr int kNAcc = kS + kNH;     // [g (S) | J^T J upper triangle]
  constexpr bool kLin = kKind == kLinear;
  __shared__ float red[kWarps][kNAcc];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  float acc[kNAcc];
#pragma unroll
  for (int i = 0; i < kNAcc; ++i) acc[i] = 0.0f;

  const float x0 = origin[(size_t)b * 2], y0 = origin[(size_t)b * 2 + 1];
  const float* wb = win + (size_t)b * h * w + (size_t)(int)y0 * w + (int)x0;
  const float* pb = pts + (size_t)b * 2 * n;
  const float* jb = jac + (size_t)b * 2 * kS * n;
  const float* tb = templ + (size_t)b * n;
  float* vb = val + (size_t)b * n;
  // clamp bounds rounded from double, as the plain form's scalars are
  const float lo = kLin ? 0.001f : 1.001f;
  const float hix = (float)((double)wc - (kLin ? 1.001 : 2.001));
  const float hiy = (float)((double)hc - (kLin ? 1.001 : 2.001));

  for (int p = tid; p < n; p += kThreads) {
    const float x = fminf(fmaxf(pb[p] - x0, lo), hix);
    const float y = fminf(fmaxf(pb[n + p] - y0, lo), hiy);
    float v, dx, dy;
    if constexpr (kLin) {
      const float xf = floorf(x), yf = floorf(y);
      linear_sample(wb + (size_t)((int)yf) * w + (int)xf, w, x - xf, y - yf,
                    v, dx, dy);
    } else {
      float wx[4], dwx[4], wy[4], dwy[4];
      cubic_axis<kKind>(x, wx, dwx);
      cubic_axis<kKind>(y, wy, dwy);
      cubic_sample(wb + (size_t)((int)floorf(y) - 1) * w +
                       ((int)floorf(x) - 1),
                   w, wx, dwx, wy, dwy, v, dx, dy);
    }
    vb[p] = v;
    const float res = tb[p] - v;
    float jm[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s)
      jm[s] = jb[(size_t)s * n + p] * dx + jb[(size_t)(kS + s) * n + p] * dy;
#pragma unroll
    for (int s = 0; s < kS; ++s) acc[s] += jm[s] * res;
    int k = kS;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
#pragma unroll
      for (int j = i; j < kS; ++j) acc[k++] += jm[i] * jm[j];
    }
  }

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < kNAcc; ++i) {
    float s = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp][i] = s;
  }
  __syncthreads();

  if (tid < kNAcc) {
    float s = 0.0f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][tid];
    if (tid < kS) {
      g_out[(size_t)b * kS + tid] = s;
    } else {
      int idx = tid - kS, i = 0;
      while (idx >= kS - i) {
        idx -= kS - i;
        ++i;
      }
      const int j = i + idx;
      float* hb = h_out + (size_t)b * kS * kS;
      hb[i * kS + j] = s;
      hb[j * kS + i] = s;
    }
  }
}

struct Args {
  const float *win, *origin, *pts, *jac, *templ;
  float *val, *g, *h;
  int batch, h_img, w_img, hc, wc, n;
  cudaStream_t stream;
};

template <int kS, int kKind>
void launch(const Args& a) {
  lk_fused_gn_kernel<kS, kKind><<<a.batch, kThreads, 0, a.stream>>>(
      a.win, a.origin, a.pts, a.jac, a.templ, a.val, a.g, a.h, a.h_img,
      a.w_img, a.hc, a.wc, a.n);
}

// the six state sizes of one tap kind; false for any other S
template <int kKind>
bool launch_s(const Args& a, int s) {
  switch (s) {
    case 2: launch<2, kKind>(a); return true;
    case 3: launch<3, kKind>(a); return true;
    case 4: launch<4, kKind>(a); return true;
    case 5: launch<5, kKind>(a); return true;
    case 6: launch<6, kKind>(a); return true;
    case 8: launch<8, kKind>(a); return true;
    default: return false;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers to contiguous float32 tensors: win (B, H, W), origin (B, 2),
// pts (B, 2, N), jac (B, 2S, N), templ (B, N), val (B, N), g (B, S),
// h (B, S, S). The (hc, wc) window at each origin lies inside the image.
// `kind` is 0 linear, 1 cubic, 2 cubic_bspl. `stream` is the caller's
// CUDA stream. Returns cudaErrorInvalidValue, launching nothing, for an S
// or kind without an instantiation, else cudaGetLastError() after the
// launch.
extern "C" int lk_fused_gn_launch(const void* win, const void* origin,
                                  const void* pts, const void* jac,
                                  const void* templ, void* val, void* g,
                                  void* h, int batch, int h_img, int w_img,
                                  int hc, int wc, int n, int s, int kind,
                                  void* stream) {
  const Args a{(const float*)win, (const float*)origin, (const float*)pts,
               (const float*)jac, (const float*)templ, (float*)val,
               (float*)g, (float*)h, batch, h_img, w_img, hc, wc, n,
               (cudaStream_t)stream};
  bool ok = false;
  if (kind == kLinear)
    ok = launch_s<kLinear>(a, s);
  else if (kind == kCubic)
    ok = launch_s<kCubic>(a, s);
  else if (kind == kBspl)
    ok = launch_s<kBspl>(a, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
