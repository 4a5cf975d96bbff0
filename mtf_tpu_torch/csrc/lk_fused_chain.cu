// Chain-fused LK iteration, SSD, one channel, linear taps, 8-DOF.
//
// Replaces the TPU kernel mtf_tpu/ops/pallas/lk_fused.py:_chain_kernel_one
// (SSD mode, ch == 1, blur 0). Contract, per tracker b:
//   inputs   win (Hc, Wc) f32 window, M0 (3, 3) window <- template-frame
//            warp, gens (8, 3, 3) SSM generators, ph (3, N) homogeneous
//            base points, templ (N,)
//   outputs  val (N,) sampled values, g (8,) = J^T (templ - val),
//            jtj (8, 8) = J^T J
// where J = dx * jx + dy * jy, (jx, jy) is the quotient-rule Jacobian of
// the projected point w.r.t. the 8 state params, and (val, dx, dy) is the
// dense-convention bilinear sample at the point clamped to
// [0.001, size - 1.001] (the replicate border; the derivative along an
// axis is 0 at an exactly integer coordinate, as phi'(0) = 0 in the dense
// form). The TPU kernel's 128-row y-bands (and their in-band mask) and
// its pad lanes are layout artifacts: here the whole window is clamped
// (band == hc semantics) and a bounds check on N replaces padding.
//
// Layout: one block per tracker, threads stride over the points; each
// thread keeps g (8) and the 36 upper-triangle entries of J^T J in
// registers, then a warp-shuffle + shared-memory block reduction writes
// them out without atomics (deterministic summation order).
//
// Bound on the H100: per tracker and iteration the block reads its
// 144x144 f32 window once from HBM (83 KB; the 4 taps per point then hit
// L1/L2), the points (12 B/point) and the template (4 B/point), writes
// val (4 B/point), and does ~200 FLOPs per point. At B = 1280, N = 2500
// that is ~0.2 GB and ~0.6 GFLOP: memory, not arithmetic, bounds it, and
// the exposed latency of the dependent tap gathers more than bandwidth
// (one launch took 0.17 ms on an H100 80GB HBM3 at 700 W, ~1.2 TB/s).
// Neighbouring threads take neighbouring points, which map to
// neighbouring pixels, so tap reads coalesce. The 44 register
// accumulators cost 178 registers per thread, one 256-thread block per
// SM, which leaves little to hide that latency; fewer live registers,
// several small-N trackers per block, taps read straight from the shared
// frame (no crop) and a bf16 window are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kS = 8;                       // state dims (homography)
constexpr int kNH = kS * (kS + 1) / 2;      // upper triangle of J^T J
constexpr int kNAcc = kS + kNH;             // g + J^T J accumulators
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
lk_fused_chain_ssd_kernel(const float* __restrict__ win,
                          const float* __restrict__ m0,
                          const float* __restrict__ gens,
                          const float* __restrict__ ph,
                          const float* __restrict__ templ,
                          float* __restrict__ val,
                          float* __restrict__ g_out,
                          float* __restrict__ h_out,
                          int hc, int wc, int n) {
  // rows 0..2: M0; rows 3 + 3 s + r: row r of M0 G_s
  __shared__ float a_rows[3 + 3 * kS][3];
  __shared__ float red[kWarps][kNAcc];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* m = m0 + (size_t)b * 9;
  if (tid < 9) a_rows[tid / 3][tid % 3] = m[tid];
  for (int e = tid; e < kS * 9; e += kThreads) {
    const int s = e / 9, r = (e / 3) % 3, k = e % 3;
    const float* G = gens + s * 9;
    a_rows[3 + 3 * s + r][k] =
        m[r * 3 + 0] * G[0 * 3 + k] + m[r * 3 + 1] * G[1 * 3 + k] +
        m[r * 3 + 2] * G[2 * 3 + k];
  }
  __syncthreads();

  float acc[kNAcc];
#pragma unroll
  for (int i = 0; i < kNAcc; ++i) acc[i] = 0.0f;

  const float* phb = ph + (size_t)b * 3 * n;
  const float* tb = templ + (size_t)b * n;
  const float* wb = win + (size_t)b * hc * wc;
  float* vb = val + (size_t)b * n;
  // clamp bounds rounded from double, as the plain form's scalars are
  const float hix = (float)((double)wc - 1.001);
  const float hiy = (float)((double)hc - 1.001);

  for (int p = tid; p < n; p += kThreads) {
    const float px = phb[p], py = phb[n + p], pw = phb[2 * n + p];
    // The derivative steps at integer coordinates, so the projection is
    // rounded exactly as the plain form rounds it: separate products and
    // sums in its order (no FMA contraction), an IEEE reciprocal, one
    // product. Both forms then put the same points on integers.
    const float q0 = __fadd_rn(__fadd_rn(__fmul_rn(a_rows[0][0], px),
                                         __fmul_rn(a_rows[0][1], py)),
                               __fmul_rn(a_rows[0][2], pw));
    const float q1 = __fadd_rn(__fadd_rn(__fmul_rn(a_rows[1][0], px),
                                         __fmul_rn(a_rows[1][1], py)),
                               __fmul_rn(a_rows[1][2], pw));
    const float q2 = __fadd_rn(__fadd_rn(__fmul_rn(a_rows[2][0], px),
                                         __fmul_rn(a_rows[2][1], py)),
                               __fmul_rn(a_rows[2][2], pw));
    const float winv = __frcp_rn(q2);
    const float xr = __fmul_rn(q0, winv);
    const float yr = __fmul_rn(q1, winv);

    const float x = fminf(fmaxf(xr, 0.001f), hix);
    const float y = fminf(fmaxf(yr, 0.001f), hiy);
    const float xf = floorf(x), yf = floorf(y);
    const float fx = x - xf, fy = y - yf;
    const float* t0 = wb + (size_t)((int)yf) * wc + (int)xf;
    const float v00 = t0[0], v01 = t0[1], v10 = t0[wc], v11 = t0[wc + 1];
    const float top = v00 * (1.0f - fx) + v01 * fx;
    const float bot = v10 * (1.0f - fx) + v11 * fx;
    const float v = top * (1.0f - fy) + bot * fy;
    const float dx = fx > 0.0f ? (v01 - v00) * (1.0f - fy) + (v11 - v10) * fy
                               : 0.0f;
    const float dy = fy > 0.0f ? bot - top : 0.0f;
    vb[p] = v;
    const float r = tb[p] - v;

    float jm[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const float* ax = a_rows[3 + 3 * s];
      const float* ay = a_rows[4 + 3 * s];
      const float* aw = a_rows[5 + 3 * s];
      const float qx = ax[0] * px + ax[1] * py + ax[2] * pw;
      const float qy = ay[0] * px + ay[1] * py + ay[2] * pw;
      const float qw = aw[0] * px + aw[1] * py + aw[2] * pw;
      const float jx = (qx - xr * qw) * winv;   // quotient rule
      const float jy = (qy - yr * qw) * winv;
      jm[s] = jx * dx + jy * dy;
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) acc[s] += jm[s] * r;
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
    for (int w = 0; w < kWarps; ++w) s += red[w][tid];
    if (tid < kS) {
      g_out[(size_t)b * kS + tid] = s;
    } else {
      int idx = tid - kS, i = 0;
      while (idx >= kS - i) {
        idx -= kS - i;
        ++i;
      }
      const int j = i + idx;
      float* h = h_out + (size_t)b * kS * kS;
      h[i * kS + j] = s;
      h[j * kS + i] = s;
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers to contiguous float32 tensors; `stream` is the caller's CUDA
// stream. Returns cudaGetLastError() after the launch.
extern "C" int lk_fused_chain_ssd(const void* win, const void* m0,
                                  const void* gens, const void* ph,
                                  const void* templ, void* val, void* g,
                                  void* jtj, int batch, int hc, int wc, int n,
                                  void* stream) {
  lk_fused_chain_ssd_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)win, (const float*)m0, (const float*)gens,
      (const float*)ph, (const float*)templ, (float*)val, (float*)g,
      (float*)jtj, hc, wc, n);
  return (int)cudaGetLastError();
}
