// Chain-fused LK iteration, 8-DOF: the SSD mode (K1), the NCC moment mode
// (K2), the ESM mean-Jacobian mode (K3) and the multi-channel SSD mode
// (K4), each with linear, Catmull-Rom or cubic B-spline taps (K1c), of one
// kernel template. Only what the trackers reach is instantiated: the four
// single-channel modes (ssd, ncc) x (no ESM, ESM) and multi-channel SSD
// without ESM, each for the three tap kinds (15 instantiations).
//
// Replaces the TPU kernel mtf_tpu/ops/pallas/lk_fused.py:_chain_kernel_one
// (ch 1-4, blur 0, kind linear / cubic / cubic_bspl; pallas_call at
// lk_fused.py:442). Contract, per tracker b:
//   inputs   win (C, Hc, Wc) f32 window (C = 1 outside the MC mode),
//            M0 (3, 3) window <- template-frame warp, gens (8, 3, 3) SSM
//            generators, ph (3, N) homogeneous base points, templ (C, N)
//            (NCC: the centred unit template n0), ESM only: j0 (8, N)
//            template-side pixel Jacobian
//   per point  the projected point, clamped to [0.001, size - 1.001]
//            (linear) or [1.001, size - 2.001] (cubic kinds): the
//            replicate border, every tap inside the window; the dense tap
//            weights phi(t) and phi'(t) at t = k - x per axis (linear:
//            2 taps, the derivative along an axis is 0 at an exactly
//            integer coordinate, as phi'(0) = 0 in the dense form; cubic:
//            4 taps, phi' continuous); (jx, jy) the quotient-rule
//            Jacobian w.r.t. the 8 state params, computed once per point;
//            per channel c: (val_c, dx_c, dy_c) from channel c's taps at
//            the shared tap positions and weights, Jm_c = dx_c jx + dy_c jy,
//            with ESM Jm := (Jm + J0) / 2
//   outputs  val (C, N), and
//            SSD: g (8) = sum_c Jm_c (templ_c - val_c),
//                 h (8, 8) = sum_c Jm_c Jm_c^T;
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
// neighbouring points of each row. The MC mode sums its channels into the
// same 44 accumulators (no register grows with C); the channel count is a
// runtime loop, so one instantiation takes C = 1-4, and the single-channel
// modes keep C = 1 at compile time. The TPU kernel builds its (Wc, TN)
// tap-weight matrices once and shares them across channels; here the
// shared part is per point: projection, warp Jacobian, tap positions and
// weights once, then C times only the tap reads and the accumulation.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32), each input read once and
// each output written once: per tracker the window pixels the points' taps
// cover (at most C x the 144x144 f32 window, 83 KB per channel), the
// points (12 B/point), the template and val (4 B/point/channel each), with
// ESM j0 (32 B/point); ~360 FLOPs per point for linear SSD, ~700 for
// cubic (4 + 4 weights of ~14 FLOPs, 16 taps x 3 sums per channel), plus
// ~130 per extra channel. At B = 1024, N = 2500, NCC + ESM: ~85 MB of
// windows, 82 MB of j0, 31 MB of points, 10 + 10 MB of template and
// values, ~0.21 GB in all, ~0.06 ms; ~0.7 GFLOP is ~0.01 ms. Memory bounds
// every mode. The kernel's own limit is the exposed latency of the
// dependent tap gathers: K1 at B = 1280, N = 2500 took 0.17 ms on an H100
// 80GB HBM3 at 700 W. Neighbouring threads take neighbouring points, which
// map to neighbouring pixels, so tap reads coalesce. The register
// accumulators leave one 256-thread block per SM, which leaves little to
// hide that latency; the NCC modes hold 21 more accumulators than SSD and
// the cubic kinds 16 more tap weights. Fewer live registers, several
// small-N trackers per block, taps read straight from the shared frame (no
// crop) and a bf16 window are later work.

#include <cuda_runtime.h>
#include <stddef.h>

#include "dense_taps.cuh"

namespace {

using dense_taps::cubic_axis;
using dense_taps::kBspl;
using dense_taps::kCubic;
using dense_taps::kLinear;

constexpr int kS = 8;                       // state dims (homography)
constexpr int kNH = kS * (kS + 1) / 2;      // upper triangle of J^T J
constexpr int kNScal = 5;                   // NCC scalar moments
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool kNcc, bool kEsm, bool kMc, int kKind>
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
                      int hc, int wc, int n, int channels) {
  // accumulator layout: [g or a (8) | J^T J upper triangle (36)], and for
  // NCC [Jm v (8) | Jm (8) | the 5 scalars]
  constexpr int kMom = kS + kNH;
  constexpr int kScal = kMom + 2 * kS;
  constexpr int kNAcc = kNcc ? kScal + kNScal : kMom;
  constexpr bool kLin = kKind == kLinear;
  // rows 0..2: M0; rows 3 + 3 s + r: row r of M0 G_s
  __shared__ float a_rows[3 + 3 * kS][3];
  __shared__ float red[kWarps][kNAcc];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nch = kMc ? channels : 1;
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

  const size_t plane = (size_t)hc * wc;
  const float* phb = ph + (size_t)b * 3 * n;
  const float* tb = templ + (size_t)b * nch * n;
  const float* wb = win + (size_t)b * nch * plane;
  const float* j0b = kEsm ? j0 + (size_t)b * kS * n : nullptr;
  float* vb = val + (size_t)b * nch * n;
  // clamp bounds rounded from double, as the plain form's scalars are
  const float lo = kLin ? 0.001f : 1.001f;
  const float hix = (float)((double)wc - (kLin ? 1.001 : 2.001));
  const float hiy = (float)((double)hc - (kLin ? 1.001 : 2.001));

  for (int p = tid; p < n; p += kThreads) {
    const float px = phb[p], py = phb[n + p], pw = phb[2 * n + p];
    // The linear derivative steps at integer coordinates, so the
    // projection is rounded exactly as the plain form rounds it: separate
    // products and sums in its order (no FMA contraction), an IEEE
    // reciprocal, one product. Both forms then put the same points on
    // integers.
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

    // the warp Jacobian, shared by every channel
    float jx[kS], jy[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const float* ax = a_rows[3 + 3 * s];
      const float* ay = a_rows[4 + 3 * s];
      const float* aw = a_rows[5 + 3 * s];
      const float qx = ax[0] * px + ax[1] * py + ax[2] * pw;
      const float qy = ay[0] * px + ay[1] * py + ay[2] * pw;
      const float qw = aw[0] * px + aw[1] * py + aw[2] * pw;
      jx[s] = (qx - xr * qw) * winv;   // quotient rule
      jy[s] = (qy - yr * qw) * winv;
    }

    // tap positions and weights, shared by every channel
    const float x = fminf(fmaxf(xr, lo), hix);
    const float y = fminf(fmaxf(yr, lo), hiy);
    float fx = 0.0f, fy = 0.0f;
    float wx[4], dwx[4], wy[4], dwy[4];
    const float* t0;
    if constexpr (kLin) {
      const float xf = floorf(x), yf = floorf(y);
      fx = x - xf;
      fy = y - yf;
      t0 = wb + (size_t)((int)yf) * wc + (int)xf;
    } else {
      cubic_axis<kKind>(x, wx, dwx);
      cubic_axis<kKind>(y, wy, dwy);
      t0 = wb + (size_t)((int)floorf(y) - 1) * wc + ((int)floorf(x) - 1);
    }

    for (int c = 0; c < nch; ++c) {
      const float* tc = t0 + c * plane;
      float v, dx, dy;
      if constexpr (kLin) {
        const float v00 = tc[0], v01 = tc[1], v10 = tc[wc], v11 = tc[wc + 1];
        const float top = v00 * (1.0f - fx) + v01 * fx;
        const float bot = v10 * (1.0f - fx) + v11 * fx;
        v = top * (1.0f - fy) + bot * fy;
        dx = fx > 0.0f ? (v01 - v00) * (1.0f - fy) + (v11 - v10) * fy : 0.0f;
        dy = fy > 0.0f ? bot - top : 0.0f;
      } else {
        // each row summed first, as the dense contractions do
        v = dx = dy = 0.0f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* row = tc + r * wc;
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
      vb[(size_t)c * n + p] = v;
      const float t = tb[(size_t)c * n + p];

      float jm[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        jm[s] = jx[s] * dx + jy[s] * dy;
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

struct Args {
  const float *win, *m0, *gens, *ph, *templ, *j0;
  float *val, *g, *h, *mom, *scal;
  int batch, hc, wc, n, channels;
  cudaStream_t stream;
};

template <bool kNcc, bool kEsm, bool kMc, int kKind>
void launch(const Args& a) {
  lk_fused_chain_kernel<kNcc, kEsm, kMc, kKind>
      <<<a.batch, kThreads, 0, a.stream>>>(a.win, a.m0, a.gens, a.ph,
                                           a.templ, a.j0, a.val, a.g, a.h,
                                           a.mom, a.scal, a.hc, a.wc, a.n,
                                           a.channels);
}

// the five modes of one tap kind; false where there is no instantiation
template <int kKind>
bool launch_mode(const Args& a, int ncc, int esm, int mc) {
  if (mc) {
    if (ncc || esm) return false;
    launch<false, false, true, kKind>(a);
  } else if (ncc && esm) {
    launch<true, true, false, kKind>(a);
  } else if (ncc) {
    launch<true, false, false, kKind>(a);
  } else if (esm) {
    launch<false, true, false, kKind>(a);
  } else {
    launch<false, false, false, kKind>(a);
  }
  return true;
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers to contiguous float32 tensors; j0 is read only when esm != 0,
// mom and scal are written only when ncc != 0 (null otherwise). `channels`
// is C (1-4) with mc != 0 and 1 otherwise; `kind` is 0 linear, 1 cubic,
// 2 cubic_bspl. `stream` is the caller's CUDA stream. Returns
// cudaErrorInvalidValue, launching nothing, for a combination without an
// instantiation, else cudaGetLastError() after the launch.
extern "C" int lk_fused_chain_launch(const void* win, const void* m0,
                                     const void* gens, const void* ph,
                                     const void* templ, const void* j0,
                                     void* val, void* g, void* h, void* mom,
                                     void* scal, int batch, int hc, int wc,
                                     int n, int channels, int ncc, int esm,
                                     int mc, int kind, void* stream) {
  const Args a{(const float*)win, (const float*)m0, (const float*)gens,
               (const float*)ph, (const float*)templ, (const float*)j0,
               (float*)val, (float*)g, (float*)h, (float*)mom,
               (float*)scal, batch, hc, wc, n, mc ? channels : 1,
               (cudaStream_t)stream};
  if (channels < 1 || channels > 4) return (int)cudaErrorInvalidValue;
  bool ok = false;
  if (kind == kLinear)
    ok = launch_mode<kLinear>(a, ncc, esm, mc);
  else if (kind == kCubic)
    ok = launch_mode<kCubic>(a, ncc, esm, mc);
  else if (kind == kBspl)
    ok = launch_mode<kBspl>(a, ncc, esm, mc);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
