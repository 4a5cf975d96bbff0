// Chain-fused LK iteration, one channel, linear taps, 8-DOF: the SSD mode
// (K1), the NCC moment mode (K2) and the ESM mean-Jacobian mode (K3) of one
// kernel template, instantiated four times (ssd, ncc) x (no ESM, ESM).
//
// Replaces the TPU kernel mtf_tpu/ops/pallas/lk_fused.py:_chain_kernel_one
// (ch == 1, blur 0; pallas_call at lk_fused.py:442). Contract, per tracker b:
//   inputs   win (Hc, Wc) f32 window, M0 (3, 3) window <- template-frame
//            warp, gens (8, 3, 3) SSM generators, ph (3, N) homogeneous
//            base points, templ (N,) (NCC: the centred unit template n0),
//            ESM only: j0 (8, N) template-side pixel Jacobian
//   per point  (val, dx, dy) the dense-convention bilinear sample at the
//            projected point clamped to [0.001, size - 1.001] (the
//            replicate border; the derivative along an axis is 0 at an
//            exactly integer coordinate, as phi'(0) = 0 in the dense
//            form), Jm = dx * jx + dy * jy with (jx, jy) the
//            quotient-rule Jacobian w.r.t. the 8 state params, and with
//            ESM Jm := (Jm + J0) / 2
//   outputs  val (N,), and
//            SSD: g (8) = Jm (templ - val), h (8, 8) = Jm Jm^T;
//            NCC: g (8) = a = Jm n0, h (8, 8) = R = Jm Jm^T,
//                 mom (2, 8) = [Jm val; Jm 1], scal (5) = (sum val,
//                 sum val^2, sum n0 val, live count, sum n0).
// The NCC gradient and selft Hessian are a nonlinear combine of these
// moments, done on the host side (ncc_combine in ops/kernels/lk_fused.py).
//
// The TPU kernel's 128-row y-bands (and their in-band mask) and its pad
// lanes are layout artifacts: here the whole window is clamped (band == hc
// semantics) and a bounds check on N replaces padding, so every point is
// live and the live count is N. No point is ever dropped from a band, so
// the TPU kernel's ESM fault (lk_fused.py:317-322: the live mask is applied
// before the average, so an out-of-band point still adds J0 / 2) cannot
// occur here.
//
// Layout: one block per tracker, threads stride over the points; each
// thread keeps its accumulators in registers (SSD: 8 + 36 = 44; NCC:
// 8 + 36 + 16 + 5 = 65), then a warp-shuffle + shared-memory block
// reduction writes them out without atomics (deterministic summation
// order). j0 is laid out (B, 8, N), so neighbouring threads read
// neighbouring points of each row.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32), each input read once and
// each output written once: per tracker the window pixels the points' taps
// cover (at most the 144x144 f32 window, 83 KB), the points (12 B/point),
// the template (4 B/point), with ESM j0 (32 B/point), and val written
// (4 B/point); ~200 FLOPs per point (SSD) to ~260 (NCC + ESM). At B = 1024,
// N = 2500, NCC + ESM: ~85 MB of windows, 82 MB of j0, 31 MB of points,
// 10 + 10 MB of template and values, ~0.21 GB in all, ~0.06 ms; ~0.7 GFLOP
// is ~0.01 ms. Memory bounds every mode. The kernel's own limit is the
// exposed latency of the dependent tap gathers: K1 at B = 1280, N = 2500
// took 0.17 ms on an H100 80GB HBM3 at 700 W. Neighbouring threads take
// neighbouring points, which map to neighbouring pixels, so tap reads
// coalesce. The register accumulators leave one 256-thread block per SM,
// which leaves little to hide that latency; the NCC modes hold 21 more
// accumulators than SSD and may spill. Fewer live registers, several
// small-N trackers per block, taps read straight from the shared frame (no
// crop) and a bf16 window are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kS = 8;                       // state dims (homography)
constexpr int kNH = kS * (kS + 1) / 2;      // upper triangle of J^T J
constexpr int kNScal = 5;                   // NCC scalar moments
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool kNcc, bool kEsm>
__global__ void __launch_bounds__(kThreads)
lk_fused_chain_kernel(const float* __restrict__ win,
                      const float* __restrict__ m0,
                      const float* __restrict__ gens,
                      const float* __restrict__ ph,
                      const float* __restrict__ templ,
                      const float* __restrict__ j0,
                      float* __restrict__ val,
                      float* __restrict__ g_out,
                      float* __restrict__ h_out,
                      float* __restrict__ mom_out,
                      float* __restrict__ scal_out,
                      int hc, int wc, int n) {
  // accumulator layout: [g or a (8) | J^T J upper triangle (36)], and for
  // NCC [Jm v (8) | Jm (8) | the 5 scalars]
  constexpr int kMom = kS + kNH;
  constexpr int kScal = kMom + 2 * kS;
  constexpr int kNAcc = kNcc ? kScal + kNScal : kMom;
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
  const float* j0b = kEsm ? j0 + (size_t)b * kS * n : nullptr;
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
    const float t = tb[p];

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
      if constexpr (kEsm) jm[s] = 0.5f * (jm[s] + j0b[(size_t)s * n + p]);
    }
    // SSD: the residual weights g; NCC: n0 weights a
    const float w = kNcc ? t : t - v;
#pragma unroll
    for (int s = 0; s < kS; ++s) acc[s] += jm[s] * w;
    int k = kS;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
#pragma unroll
      for (int j = i; j < kS; ++j) acc[k++] += jm[i] * jm[j];
    }
    if constexpr (kNcc) {
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        acc[kMom + s] += jm[s] * v;
        acc[kMom + kS + s] += jm[s];
      }
      acc[kScal + 0] += v;
      acc[kScal + 1] += v * v;
      acc[kScal + 2] += t * v;
      acc[kScal + 3] += 1.0f;
      acc[kScal + 4] += t;
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
    } else if (tid < kMom) {
      int idx = tid - kS, i = 0;
      while (idx >= kS - i) {
        idx -= kS - i;
        ++i;
      }
      const int j = i + idx;
      float* h = h_out + (size_t)b * kS * kS;
      h[i * kS + j] = s;
      h[j * kS + i] = s;
    } else if (tid < kScal) {
      mom_out[(size_t)b * 2 * kS + (tid - kMom)] = s;
    } else {
      scal_out[(size_t)b * kNScal + (tid - kScal)] = s;
    }
  }
}

template <bool kNcc, bool kEsm>
void launch(const void* win, const void* m0, const void* gens,
            const void* ph, const void* templ, const void* j0, void* val,
            void* g, void* h, void* mom, void* scal, int batch, int hc,
            int wc, int n, cudaStream_t stream) {
  lk_fused_chain_kernel<kNcc, kEsm><<<batch, kThreads, 0, stream>>>(
      (const float*)win, (const float*)m0, (const float*)gens,
      (const float*)ph, (const float*)templ, (const float*)j0, (float*)val,
      (float*)g, (float*)h, (float*)mom, (float*)scal, hc, wc, n);
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers to contiguous float32 tensors; j0 is read only when esm != 0,
// mom and scal are written only when ncc != 0 (null otherwise). `stream`
// is the caller's CUDA stream. Returns cudaGetLastError() after the
// launch.
extern "C" int lk_fused_chain_launch(const void* win, const void* m0,
                                     const void* gens, const void* ph,
                                     const void* templ, const void* j0,
                                     void* val, void* g, void* h, void* mom,
                                     void* scal, int batch, int hc, int wc,
                                     int n, int ncc, int esm, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ncc && esm)
    launch<true, true>(win, m0, gens, ph, templ, j0, val, g, h, mom, scal,
                       batch, hc, wc, n, st);
  else if (ncc)
    launch<true, false>(win, m0, gens, ph, templ, j0, val, g, h, mom, scal,
                        batch, hc, wc, n, st);
  else if (esm)
    launch<false, true>(win, m0, gens, ph, templ, j0, val, g, h, mom, scal,
                        batch, hc, wc, n, st);
  else
    launch<false, false>(win, m0, gens, ph, templ, j0, val, g, h, mom, scal,
                         batch, hc, wc, n, st);
  return (int)cudaGetLastError();
}
