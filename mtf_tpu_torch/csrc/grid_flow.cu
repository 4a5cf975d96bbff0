// Grid flow (K5): every joint 2-DOF LK iteration of one pyramid level, for
// all patches of B grid trackers, in one launch.
//
// Replaces the TPU kernel mtf_tpu/ops/pallas/grid_flow.py:_kernel
// (pallas_call at grid_flow.py:243, in _batched :223). Contract, per
// tracker b and patch p (its n points are columns [p*n, (p+1)*n) of pts):
//   inputs   win (Hc, Wc) f32 window, pts (2, P*n) window px, templ (P*n)
//            (standardised per patch when zncc), scale: template units ->
//            window px
//   per iteration, disp (2) in template units starting at 0
//            x = clamp(px + disp.x * scale, 0.001, Wc - 1.001), y alike;
//            (val, dx, dy) the dense-convention bilinear sample (the
//            derivative along an axis is 0 at an exactly integer
//            coordinate); with zncc val := (val - mu) / (sqrt(var) + 1e-6)
//            per patch, mean first, then var = sum (val - mu)^2 / n (two
//            passes: one-pass E[v^2] - mu^2 cancels catastrophically on
//            8-bit imagery); r = val - templ; (Jx, Jy) = (dx, dy) * scale;
//            H = [sum JxJx + 1e-6, sum JxJy; ., sum JyJy + 1e-6],
//            g = [sum Jx r, sum Jy r]; det guarded as ops/linalg.py:solve2x2
//            (|det| < 1e-12 -> sign(det) * 1e-12 + 1e-12); disp -= H^-1 g
//   output   disp (2) per patch, in template units.
//
// The TPU kernel's bf16 window, iota block-indicator reductions, point
// tiles and 80-row y-bands with their in-band mask are layout artifacts:
// here the whole window is clamped and every point is live (the semantics
// of the JAX package's XLA path, sm/grid.py:_track_patches_mm).
//
// Layout: one segment of `lanes` threads per (tracker, patch), lanes the
// power of two >= n up to 32, so a warp holds 32 / lanes whole patches
// (two at the grid's coarse level, n = 16); each lane keeps K = n / lanes
// (rounded up to a power of two) points, their template values and their
// samples in registers for the whole launch, and the displacement stays in
// registers across iterations (the TPU kernel kept it in VMEM). Sums are
// xor-butterfly shuffles inside the segment: IEEE addition commutes, so
// every lane gets the same bits, solves the same 2x2 and carries the same
// displacement; the order is fixed (no atomics), so results repeat.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32), each input read once and
// each output written once: the window pixels the taps cover (at most the
// window), 8 B of points and 4 B of template per point, the scale, and
// 8 B of disp per patch; ~60 FLOPs per point per iteration. At B = 384,
// P = 100: level 0 (n = 64, 1 iteration, 160 px window) moves ~33 KB of
// covered window, 51 KB of points and 26 KB of template per tracker, ~42 MB
// in all, ~0.013 ms; level 1 (n = 16, 8 iterations, 96 px window) moves
// ~10 MB (~0.003 ms) against ~0.3 GFLOP (~0.0045 ms), compute-bound at
// ~0.005 ms. The tap gathers are dependent loads; windows are read through
// the read-only cache (__ldg), and a tracker's 100 patches run on
// neighbouring warps, so its window stays in L1/L2 while they run.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float seg_sum(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
grid_flow_kernel(const float* __restrict__ win, const float* __restrict__ pts,
                 const float* __restrict__ templ,
                 const float* __restrict__ scale, float* __restrict__ disp,
                 int batch, int hc, int wc, int n_patches, int n, int lanes,
                 int n_iters, int zncc) {
  const size_t gtid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t seg = gtid / lanes;                  // (tracker, patch)
  const int lane = (int)(gtid % lanes);
  // segments past the last patch still run every shuffle, on no points
  const bool active = seg < (size_t)batch * n_patches;
  const int b = active ? (int)(seg / n_patches) : 0;
  const int p = active ? (int)(seg % n_patches) : 0;
  const size_t pn = (size_t)n_patches * n;
  const float* wb = win + (size_t)b * hc * wc;
  const float* xb = pts + (size_t)b * 2 * pn + (size_t)p * n;
  const float* yb = xb + pn;
  const float* tb = templ + (size_t)b * pn + (size_t)p * n;
  const float s = scale[b];
  // clamp bounds rounded from double, as the plain form's scalars are
  const float hix = (float)((double)wc - 1.001);
  const float hiy = (float)((double)hc - 1.001);
  const float nf = (float)n;

  float px[K], py[K], tv[K];
  bool live[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int i = lane + j * lanes;
    live[j] = active && i < n;
    px[j] = live[j] ? xb[i] : 0.0f;
    py[j] = live[j] ? yb[i] : 0.0f;
    tv[j] = live[j] ? tb[i] : 0.0f;
  }

  float dxp = 0.0f, dyp = 0.0f;           // displacement, template units
  for (int it = 0; it < n_iters; ++it) {
    // one rounding for the offset and one for the sum, as the plain form
    // (no FMA contraction): both forms put the same points on integers
    const float ox = __fmul_rn(dxp, s), oy = __fmul_rn(dyp, s);
    float v[K], gx[K], gy[K];
    float s1 = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      v[j] = gx[j] = gy[j] = 0.0f;
      if (!live[j]) continue;
      const float x = fminf(fmaxf(__fadd_rn(px[j], ox), 0.001f), hix);
      const float y = fminf(fmaxf(__fadd_rn(py[j], oy), 0.001f), hiy);
      const float xf = floorf(x), yf = floorf(y);
      const float fx = x - xf, fy = y - yf;
      const float* t0 = wb + (size_t)((int)yf) * wc + (int)xf;
      const float v00 = __ldg(t0), v01 = __ldg(t0 + 1);
      const float v10 = __ldg(t0 + wc), v11 = __ldg(t0 + wc + 1);
      const float top = v00 * (1.0f - fx) + v01 * fx;
      const float bot = v10 * (1.0f - fx) + v11 * fx;
      v[j] = top * (1.0f - fy) + bot * fy;
      gx[j] = fx > 0.0f ? (v01 - v00) * (1.0f - fy) + (v11 - v10) * fy : 0.0f;
      gy[j] = fy > 0.0f ? bot - top : 0.0f;
      s1 += v[j];
    }
    if (zncc) {
      const float mu = seg_sum(s1, lanes) / nf;
      float s2 = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        v[j] = live[j] ? v[j] - mu : 0.0f;
        s2 += v[j] * v[j];
      }
      const float inv = 1.0f / (sqrtf(seg_sum(s2, lanes) / nf) + 1e-6f);
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] *= inv;
    }
    float a[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (!live[j]) continue;
      const float r = v[j] - tv[j];
      const float jx = gx[j] * s, jy = gy[j] * s;
      a[0] += jx * jx;
      a[1] += jx * jy;
      a[2] += jy * jy;
      a[3] += jx * r;
      a[4] += jy * r;
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) a[k] = seg_sum(a[k], lanes);
    const float hxx = a[0] + 1e-6f, hxy = a[1], hyy = a[2] + 1e-6f;
    float det = hxx * hyy - hxy * hxy;
    if (fabsf(det) < 1e-12f) {
      const float sg = (float)((det > 0.0f) - (det < 0.0f));
      det = sg * 1e-12f + 1e-12f;
    }
    dxp -= (hyy * a[3] - hxy * a[4]) / det;
    dyp -= (hxx * a[4] - hxy * a[3]) / det;
  }
  if (active && lane == 0) {
    disp[seg * 2] = dxp;
    disp[seg * 2 + 1] = dyp;
  }
}

template <int K>
int launch(const void* win, const void* pts, const void* templ,
           const void* scale, void* disp, int batch, int hc, int wc,
           int n_patches, int n, int lanes, int n_iters, int zncc,
           cudaStream_t stream) {
  const size_t threads = (size_t)batch * n_patches * lanes;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  grid_flow_kernel<K><<<blocks, kThreads, 0, stream>>>(
      (const float*)win, (const float*)pts, (const float*)templ,
      (const float*)scale, (float*)disp, batch, hc, wc, n_patches, n, lanes,
      n_iters, zncc);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device pointers
// to contiguous float32 tensors: win (B, Hc, Wc), pts (B, 2, P*n),
// templ (B, P*n), scale (B), disp (B, P, 2) written. 1 <= n <= 1024.
// `stream` is the caller's CUDA stream. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for an n out of range).
extern "C" int grid_flow_launch(const void* win, const void* pts,
                                const void* templ, const void* scale,
                                void* disp, int batch, int hc, int wc,
                                int n_patches, int n, int n_iters, int zncc,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int lanes = 1;
  while (lanes < n && lanes < 32) lanes <<= 1;
  const int per_lane = (n + lanes - 1) / lanes;
#define GRID_FLOW_CASE(K)                                                   \
  if (per_lane <= K)                                                        \
    return launch<K>(win, pts, templ, scale, disp, batch, hc, wc, n_patches, \
                     n, lanes, n_iters, zncc, st);
  GRID_FLOW_CASE(1)
  GRID_FLOW_CASE(2)
  GRID_FLOW_CASE(4)
  GRID_FLOW_CASE(8)
  GRID_FLOW_CASE(16)
  GRID_FLOW_CASE(32)
#undef GRID_FLOW_CASE
  return (int)cudaErrorInvalidValue;
}
