// Grid flow (K5, and K5c with cubic taps): every joint 2-DOF LK iteration
// of one pyramid level, for all patches of B grid trackers, in one launch.
//
// Replaces the TPU kernel mtf_tpu/ops/pallas/grid_flow.py:_kernel
// (pallas_call at grid_flow.py:243, in _batched :223; kind linear, cubic or
// cubic_bspl, :94-96 and :145-148). Contract, per tracker b and patch p (its
// n points are columns [p*n, (p+1)*n) of pts):
//   inputs   win (Hc, Wc) f32 window, pts (2, P*n) window px, templ (P*n)
//            (standardised per patch when zncc), scale: template units ->
//            window px
//   per iteration, disp (2) in template units starting at 0
//            x = clamp(px + disp.x * scale, lo, Wc - hi), y alike, with
//            [lo, hi] = [0.001, 1.001] for linear taps and [1.001, 2.001]
//            for the 4x4 cubic taps (every tap inside the window);
//            (val, dx, dy) the dense-convention sample: linear, where the
//            derivative along an axis is 0 at an exactly integer
//            coordinate, or cubic with the weights phi(t), -phi'(t) at
//            t = k - x of dense_taps.cuh, each tap row summed first (as
//            the dense contractions and the plain form do); with zncc
//            val := (val - mu) / (sqrt(var) + 1e-6)
//            per patch, mean first, then var = sum (val - mu)^2 / n (two
//            passes: one-pass E[v^2] - mu^2 cancels catastrophically on
//            8-bit imagery); r = val - templ; (Jx, Jy) = (dx, dy) * scale;
//            H = [sum JxJx + 1e-6, sum JxJy; ., sum JyJy + 1e-6],
//            g = [sum Jx r, sum Jy r]; det guarded as ops/linalg.py:solve2x2
//            (|det| < 1e-12 -> sign(det) * 1e-12 + 1e-12); disp -= H^-1 g
//   output   disp (2) per patch, in template units.
//
// The TPU kernel's iota block-indicator reductions, point tiles and
// 80-row y-bands with their in-band mask are layout artifacts: here the
// whole window is clamped and every point is live (the semantics of the
// JAX package's XLA path, sm/grid.py:_track_patches_mm). Its bf16 window
// and tap weights are what that path computes with `interp_bf16`: a build
// of its own here (-DGF_BF16=1) rounds the tap and derivative weights to
// bfloat16 (dense_taps::tap_weight; the cubic weights computed in the
// plain form's order first), the caller having rounded the window; every
// product and sum stays float32. The build without it is unchanged.
//
// Layout (chosen per (n, n_iters) by ops/kernels/grid_flow.py:layout and
// passed in): one segment of `lanes` threads per (tracker, patch), lanes a
// power of two up to 32, so a warp holds 32 / lanes whole patches; each
// lane takes K points (K a power of two, lanes x K >= n): point j of lane
// l is l + j * lanes. Up to K = 8 a lane keeps its points' coordinates and
// template values in registers for the whole launch and their samples
// through an iteration; wider lanes re-read their points and sample their
// taps again for the sums. The displacement stays in registers across
// iterations (the TPU kernel kept it in VMEM).
// Sums: each lane sums its K points pairwise (a balanced tree whose leaf
// pairs are one product and one FMA, as a running FMA sum of two points
// is), then an xor-butterfly of shuffles sums the lanes of the segment:
// the whole patch is a balanced tree, no less accurate than a running sum,
// IEEE addition commutes, so every lane gets the same bits, solves the
// same 2x2 and carries the same displacement; the order is fixed (no
// atomics), so results repeat. The tap kind is a template parameter beside
// K: 6 x 3 instantiations.
//
// What bounds it. Every iteration of a patch is one serial chain: the tap
// gathers, the sums, the butterfly and the damped 2x2 solve (two IEEE
// divisions), and only the gathers and the sums are the work the bound
// counts. With one lane per point or two (32 lanes at n = 64), the
// butterfly (5 steps of 5 shuffles and adds) and the solve, which every
// lane of the segment repeats, issued more than half of the instructions,
// so the kernel was issue-bound at 7.7x its operations bound on Median
// Flow's shapes. With 8 points a lane (8 lanes at n = 64; 4 x 4 at
// n = 16, 16 x 4 for a single iteration) the butterfly shrinks to 3 or 2
// steps, the solve is shared by 4-8x more points per lane, and each lane
// has 4-8 independent tap gathers in flight on the chain; index
// arithmetic is 32-bit. On an H100 80GB HBM3 at 700 W (PERF.md §6)
// Median Flow's six launches went from 2.00 to 1.16 ms (bound 0.26,
// operations) and rklt's level 1 from 0.054 to 0.025 ms. What bounds it
// now is the per-point sampling itself (clamp, floor, four gathers, the
// lerps and the derivative selects, ~40 instructions a point and
// iteration against the bound's 60 FLOPs), then the per-iteration
// butterflies (two more with zncc) and the solve.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32), each input read once and
// each output written once: the window pixels the taps cover (at most the
// window), 8 B of points and 4 B of template per point, the scale, and
// 8 B of disp per patch; the FLOPs per point per iteration are counted
// once, in chip_smoke.py (K5_FLOPS_PER_PT_ITER: 60 with linear taps, 230
// with cubic ones), which computes the bound from them.
// At B = 384, P = 100: level 0 (n = 64, 1 iteration, 160 px window) moves
// ~33 KB of covered window, 51 KB of points and 26 KB of template per
// tracker, ~42 MB in all, ~0.013 ms; level 1 (n = 16, 8 iterations, 96 px
// window) moves ~10 MB (~0.003 ms) against ~0.3 GFLOP linear (~0.0045 ms)
// or ~1.1 GFLOP cubic (~0.017 ms), so level 1 is compute-bound. The tap
// gathers are dependent loads; windows are read through the read-only
// cache (__ldg), and a tracker's 100 patches run on neighbouring warps, so
// its window stays in L1/L2 while they run.

#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

#include "dense_taps.cuh"

#ifndef GF_BF16
#define GF_BF16 0
#endif

namespace {

using dense_taps::cubic_axis;
using dense_taps::kBspl;
using dense_taps::kCubic;
using dense_taps::kLinear;

constexpr int kThreads = 256;
constexpr int kMaxLanes = 32;
constexpr bool kBf16 = GF_BF16 != 0;   // the bfloat16-operand flag

__device__ __forceinline__ float seg_sum(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// seg_sum of the 5 per-patch sums in one butterfly: each value adds in
// seg_sum's order, and the 5 shuffles of a step are independent
__device__ __forceinline__ void seg_sum5(float (&a)[5], int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 5; ++k)
      a[k] += __shfl_xor_sync(0xffffffffu, a[k], off);
  }
}

template <int J>
using Idx = std::integral_constant<int, J>;

// Pairwise sums over a lane's points [Lo, Lo + Len) of M per-point
// quantities: `leaf(Idx<j>, out)` sets the M terms of point j, and
// `pair(Idx<j>, out)` those of points j and j + 1 summed with one product
// and one FMA each; halves are added, so the order is fixed.
template <int Lo, int Len, int M, class Leaf, class Pair>
__device__ __forceinline__ void tree_sum(Leaf& leaf, Pair& pair,
                                         float (&out)[M]) {
  if constexpr (Len == 1) {
    leaf(Idx<Lo>{}, out);
  } else if constexpr (Len == 2) {
    pair(Idx<Lo>{}, out);
  } else {
    float hi[M];
    tree_sum<Lo, Len / 2>(leaf, pair, out);
    tree_sum<Lo + Len / 2, Len / 2>(leaf, pair, hi);
#pragma unroll
    for (int m = 0; m < M; ++m) out[m] += hi[m];
  }
}

// Value and derivatives (the dense convention) of the window `wb` (row
// stride wc) at a clamped position (x, y): bilinear, the derivative along
// an axis 0 at an exactly integer coordinate; or 4x4 cubic taps, each tap
// row summed first, as the dense contractions and the plain form do.
template <int kKind>
__device__ __forceinline__ void sample_taps(const float* __restrict__ wb,
                                            int wc, float x, float y,
                                            float& v, float& gx, float& gy) {
  if constexpr (kKind == kLinear && kBf16) {
    const float xf = floorf(x), yf = floorf(y);
    const float* t0 = wb + ((int)yf * wc + (int)xf);
    dense_taps::linear_taps<true>(__ldg(t0), __ldg(t0 + 1), __ldg(t0 + wc),
                                  __ldg(t0 + wc + 1), x - xf, y - yf, v, gx,
                                  gy);
  } else if constexpr (kKind == kLinear) {
    const float xf = floorf(x), yf = floorf(y);
    const float fx = x - xf, fy = y - yf;
    const float* t0 = wb + ((int)yf * wc + (int)xf);
    const float v00 = __ldg(t0), v01 = __ldg(t0 + 1);
    const float v10 = __ldg(t0 + wc), v11 = __ldg(t0 + wc + 1);
    const float top = v00 * (1.0f - fx) + v01 * fx;
    const float bot = v10 * (1.0f - fx) + v11 * fx;
    v = top * (1.0f - fy) + bot * fy;
    gx = fx > 0.0f ? (v01 - v00) * (1.0f - fy) + (v11 - v10) * fy : 0.0f;
    gy = fy > 0.0f ? bot - top : 0.0f;
  } else {
    float wx[4], dwx[4], wy[4], dwy[4];
    cubic_axis<kKind, kBf16>(x, wx, dwx);
    cubic_axis<kKind, kBf16>(y, wy, dwy);
    const float* t0 = wb + (((int)floorf(y) - 1) * wc + ((int)floorf(x) - 1));
    v = gx = gy = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* row = t0 + r * wc;
      float rs = 0.0f, rd = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pix = __ldg(row + i);
        rs += wx[i] * pix;
        rd += dwx[i] * pix;
      }
      v += wy[r] * rs;
      gx += wy[r] * rd;
      gy += dwy[r] * rs;
    }
  }
}

// The body of one launch; the kernels below differ only in their launch
// bounds.
template <int K, int kKind>
__device__ __forceinline__ void grid_flow_body(
    const float* __restrict__ win, const float* __restrict__ pts,
    const float* __restrict__ templ, const float* __restrict__ scale,
    float* __restrict__ disp, int batch, int hc, int wc, int n_patches,
    int n, int lanes, int n_iters, int zncc) {
  const size_t gtid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t seg = gtid / lanes;                  // (tracker, patch)
  const int lane = (int)(gtid % lanes);
  // segments past the last patch still run every shuffle, on no points
  const bool active = seg < (size_t)batch * n_patches;
  const int b = active ? (int)(seg / n_patches) : 0;
  const int p = active ? (int)(seg % n_patches) : 0;
  const size_t pn = (size_t)n_patches * n;
  const float* wb = win + (size_t)b * hc * wc;
  const float* xb = pts + (size_t)b * 2 * pn + (size_t)p * n + lane;
  const float* yb = xb + pn;
  const float* tb = templ + (size_t)b * pn + (size_t)p * n + lane;
  const float s = scale[b];
  constexpr bool kLin = kKind == kLinear;
  // clamp bounds rounded from double, as the plain form's scalars are
  const float lo = kLin ? 0.001f : 1.001f;
  const float hix = (float)((double)wc - (kLin ? 1.001 : 2.001));
  const float hiy = (float)((double)hc - (kLin ? 1.001 : 2.001));
  const float nf = (float)n;

  // point j of this lane is lane + j * lanes; it is live while < n
  const int n_mine = active ? n - lane : 0;
  auto live = [&](int j) { return j * lanes < n_mine; };
  // Up to 8 points per lane (n <= 256 at 32 lanes, every grid level at any
  // layout) keep their coordinates, template values and samples in
  // registers; wider lanes keep only the values between the passes of an
  // iteration, re-read their points through the read-only cache and
  // sample the taps again for the sums, which keeps them under the
  // 255-register cap without spills.
  constexpr bool kHold = K <= 8;
  constexpr int kHeld = kHold ? K : 1;
  float px[kHeld], py[kHeld], tv[kHeld];
  if constexpr (kHold) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      px[j] = live(j) ? xb[j * lanes] : 0.0f;
      py[j] = live(j) ? yb[j * lanes] : 0.0f;
      tv[j] = live(j) ? tb[j * lanes] : 0.0f;
    }
  }

  float dxp = 0.0f, dyp = 0.0f;           // displacement, template units
  for (int it = 0; it < n_iters; ++it) {
    // one rounding for the offset and one for the sum, as the plain form
    // (no FMA contraction): both forms put the same points on integers
    const float ox = __fmul_rn(dxp, s), oy = __fmul_rn(dyp, s);
    // value and derivatives at live point j of this lane
    auto sample_point = [&](int j, float& v, float& gx, float& gy) {
      float bx, by;
      if constexpr (kHold) {
        bx = px[j];
        by = py[j];
      } else {
        bx = __ldg(xb + j * lanes);
        by = __ldg(yb + j * lanes);
      }
      const float x = fminf(fmaxf(__fadd_rn(bx, ox), lo), hix);
      const float y = fminf(fmaxf(__fadd_rn(by, oy), lo), hiy);
      sample_taps<kKind>(wb, wc, x, y, v, gx, gy);
    };
    // every live point's samples first: K independent gathers in flight
    float v[K], gx[kHeld], gy[kHeld];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      v[j] = 0.0f;
      if constexpr (kHold) gx[j] = gy[j] = 0.0f;
      if (!live(j)) continue;
      float gxj, gyj;
      sample_point(j, v[j], gxj, gyj);
      if constexpr (kHold) {
        gx[j] = gxj;
        gy[j] = gyj;
      }
    }
    if (zncc) {
      // dead points hold 0 and stay 0: they add nothing to any sum
      auto v_leaf = [&](auto jc, float (&o)[1]) { o[0] = v[jc.value]; };
      auto v_pair = [&](auto jc, float (&o)[1]) {
        o[0] = v[jc.value] + v[jc.value + 1];
      };
      float s1[1];
      tree_sum<0, K>(v_leaf, v_pair, s1);
      const float mu = seg_sum(s1[0], lanes) / nf;
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = live(j) ? v[j] - mu : 0.0f;
      auto c_leaf = [&](auto jc, float (&o)[1]) {
        o[0] = v[jc.value] * v[jc.value];
      };
      auto c_pair = [&](auto jc, float (&o)[1]) {
        constexpr int j = decltype(jc)::value;
        o[0] = __fmaf_rn(v[j + 1], v[j + 1], __fmul_rn(v[j], v[j]));
      };
      float s2[1];
      tree_sum<0, K>(c_leaf, c_pair, s2);
      const float inv = 1.0f / (sqrtf(seg_sum(s2[0], lanes) / nf) + 1e-6f);
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] *= inv;
    }
    // the 5 per-patch sums [JxJx, JxJy, JyJy, Jx r, Jy r]: the terms of
    // point j from its Jacobian (jx, jy) and residual r, 0 where dead
    auto point_terms = [&](int j, float& jx, float& jy, float& r) {
      jx = jy = r = 0.0f;
      if (!live(j)) return;
      float dx, dy, t;
      if constexpr (kHold) {
        dx = gx[j];
        dy = gy[j];
        t = tv[j];
      } else {
        float vj;
        sample_point(j, vj, dx, dy);
        t = __ldg(tb + j * lanes);
      }
      r = v[j] - t;
      jx = dx * s;
      jy = dy * s;
    };
    auto a_leaf = [&](auto jc, float (&o)[5]) {
      float jx, jy, r;
      point_terms(jc.value, jx, jy, r);
      o[0] = __fmul_rn(jx, jx);
      o[1] = __fmul_rn(jx, jy);
      o[2] = __fmul_rn(jy, jy);
      o[3] = __fmul_rn(jx, r);
      o[4] = __fmul_rn(jy, r);
    };
    auto a_pair = [&](auto jc, float (&o)[5]) {
      constexpr int j = decltype(jc)::value;
      float jx, jy, r, kx, ky, q;
      point_terms(j, jx, jy, r);
      point_terms(j + 1, kx, ky, q);
      o[0] = __fmaf_rn(kx, kx, __fmul_rn(jx, jx));
      o[1] = __fmaf_rn(kx, ky, __fmul_rn(jx, jy));
      o[2] = __fmaf_rn(ky, ky, __fmul_rn(jy, jy));
      o[3] = __fmaf_rn(kx, q, __fmul_rn(jx, r));
      o[4] = __fmaf_rn(ky, q, __fmul_rn(jy, r));
    };
    float a[5];
    tree_sum<0, K>(a_leaf, a_pair, a);
    seg_sum5(a, lanes);
    const float hxx = a[0] + 1e-6f, hxy = a[1], hyy = a[2] + 1e-6f;
    const float gxr = a[3], gyr = a[4];
    float det = hxx * hyy - hxy * hxy;
    if (fabsf(det) < 1e-12f) {
      const float sg = (float)((det > 0.0f) - (det < 0.0f));
      det = sg * 1e-12f + 1e-12f;
    }
    dxp -= (hyy * gxr - hxy * gyr) / det;
    dyp -= (hxx * gyr - hxy * gxr) / det;
  }
  if (active && lane == 0) {
    disp[seg * 2] = dxp;
    disp[seg * 2 + 1] = dyp;
  }
}

#define GRID_FLOW_PARAMS                                                    \
  const float* __restrict__ win, const float* __restrict__ pts,             \
      const float* __restrict__ templ, const float* __restrict__ scale,     \
      float* __restrict__ disp, int batch, int hc, int wc, int n_patches,   \
      int n, int lanes, int n_iters, int zncc
#define GRID_FLOW_ARGS                                                      \
  win, pts, templ, scale, disp, batch, hc, wc, n_patches, n, lanes, n_iters, \
      zncc

// Up to 4 points per lane, and 8 with cubic taps: ptxas's own register
// budget for 256 threads.
template <int K, int kKind>
__global__ void __launch_bounds__(kThreads)
grid_flow_kernel(GRID_FLOW_PARAMS) {
  grid_flow_body<K, kKind>(GRID_FLOW_ARGS);
}

// 8 points per lane with linear taps: with its own budget ptxas aimed at
// 3 blocks per SM and spilled (80 registers, 8 B); asking for 3 blocks
// leaves it up to 85 registers and no spill. The cubic kinds need more
// (118-127 registers) and keep ptxas's own budget.
template <int K, int kKind>
__global__ void __launch_bounds__(kThreads, 3)
grid_flow_kernel_8(GRID_FLOW_PARAMS) {
  grid_flow_body<K, kKind>(GRID_FLOW_ARGS);
}

// The bfloat16 build's cubic kinds up to 8 points per lane (their weights
// each operation rounded on its own, then to bfloat16): ptxas's own budget
// spilled at 4 points per lane; two blocks per SM leave up to 128
// registers.
template <int K, int kKind>
__global__ void __launch_bounds__(kThreads, 2)
grid_flow_kernel_2(GRID_FLOW_PARAMS) {
  grid_flow_body<K, kKind>(GRID_FLOW_ARGS);
}

// 16 and 32 points per lane: one block per SM is enough, which lets ptxas
// use up to 255 registers (with the default budget the cubic_bspl lane of
// 16 points spills).
template <int K, int kKind>
__global__ void __launch_bounds__(kThreads, 1)
grid_flow_kernel_wide(GRID_FLOW_PARAMS) {
  grid_flow_body<K, kKind>(GRID_FLOW_ARGS);
}

template <int K, int kKind>
int launch(const void* win, const void* pts, const void* templ,
           const void* scale, void* disp, int batch, int hc, int wc,
           int n_patches, int n, int lanes, int n_iters, int zncc,
           cudaStream_t stream) {
  const size_t threads = (size_t)batch * n_patches * lanes;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  const float *w = (const float*)win, *p = (const float*)pts,
              *t = (const float*)templ, *s = (const float*)scale;
  float* d = (float*)disp;
  if constexpr (K >= 16)
    grid_flow_kernel_wide<K, kKind><<<blocks, kThreads, 0, stream>>>(
        w, p, t, s, d, batch, hc, wc, n_patches, n, lanes, n_iters, zncc);
  else if constexpr (K == 8 && kKind == kLinear)
    grid_flow_kernel_8<K, kKind><<<blocks, kThreads, 0, stream>>>(
        w, p, t, s, d, batch, hc, wc, n_patches, n, lanes, n_iters, zncc);
  else if constexpr (kBf16 && kKind != kLinear)
    grid_flow_kernel_2<K, kKind><<<blocks, kThreads, 0, stream>>>(
        w, p, t, s, d, batch, hc, wc, n_patches, n, lanes, n_iters, zncc);
  else
    grid_flow_kernel<K, kKind><<<blocks, kThreads, 0, stream>>>(
        w, p, t, s, d, batch, hc, wc, n_patches, n, lanes, n_iters, zncc);
  return (int)cudaGetLastError();
}

#undef GRID_FLOW_ARGS
#undef GRID_FLOW_PARAMS

template <int kKind>
int launch_kind(const void* win, const void* pts, const void* templ,
                const void* scale, void* disp, int batch, int hc, int wc,
                int n_patches, int n, int lanes, int per_lane, int n_iters,
                int zncc, cudaStream_t st) {
#define GRID_FLOW_CASE(K)                                                   \
  if (per_lane == K)                                                        \
    return launch<K, kKind>(win, pts, templ, scale, disp, batch, hc, wc,    \
                            n_patches, n, lanes, n_iters, zncc, st);
  GRID_FLOW_CASE(1)
  GRID_FLOW_CASE(2)
  GRID_FLOW_CASE(4)
  GRID_FLOW_CASE(8)
  GRID_FLOW_CASE(16)
  GRID_FLOW_CASE(32)
#undef GRID_FLOW_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device pointers
// to contiguous float32 tensors: win (B, Hc, Wc), pts (B, 2, P*n),
// templ (B, P*n), scale (B), disp (B, P, 2) written. 1 <= n <= 1024; the
// layout is `lanes` threads per patch (a power of two up to 32) of
// `per_lane` points each (1, 2, 4, 8, 16 or 32), lanes x per_lane >= n
// (ops/kernels/grid_flow.py:layout picks it); `kind` is 0 linear, 1 cubic,
// 2 cubic_bspl; `bf16` must be this build's flag (GF_BF16: 1 rounds the
// tap and derivative weights to bfloat16, the window holding values the
// caller rounded: the bfloat16-operand flag of `interp_bf16`). `stream` is
// the caller's CUDA stream. Returns
// cudaErrorInvalidValue, launching nothing, for an n, a layout or a kind
// out of range, else cudaGetLastError() after the launch.
extern "C" int grid_flow_launch(const void* win, const void* pts,
                                const void* templ, const void* scale,
                                void* disp, int batch, int hc, int wc,
                                int n_patches, int n, int n_iters, int zncc,
                                int kind, int lanes, int per_lane, int bf16,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 1 || n > 1024 || lanes < 1 || lanes > kMaxLanes ||
      (lanes & (lanes - 1)) || lanes * per_lane < n || (bf16 != 0) != kBf16)
    return (int)cudaErrorInvalidValue;
  if (kind == kLinear)
    return launch_kind<kLinear>(win, pts, templ, scale, disp, batch, hc, wc,
                                n_patches, n, lanes, per_lane, n_iters, zncc,
                                st);
  if (kind == kCubic)
    return launch_kind<kCubic>(win, pts, templ, scale, disp, batch, hc, wc,
                               n_patches, n, lanes, per_lane, n_iters, zncc,
                               st);
  if (kind == kBspl)
    return launch_kind<kBspl>(win, pts, templ, scale, disp, batch, hc, wc,
                              n_patches, n, lanes, per_lane, n_iters, zncc,
                              st);
  return (int)cudaErrorInvalidValue;
}
