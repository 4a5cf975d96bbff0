// Chain-fused LK iteration at state size S (one library per S, built with
// -DLK_S=<S>; 8 when undefined): the SSD mode (K1), the NCC moment mode
// (K2), the ESM mean-Jacobian mode (K3) and the multi-channel SSD mode
// (K4), each with linear, Catmull-Rom or cubic B-spline taps (K1c), plain
// or binomially blurred (K4b), of one kernel template. Only what the
// trackers reach is instantiated: the four single-channel modes (ssd, ncc)
// x (no ESM, ESM) and multi-channel SSD without ESM, each for the three
// tap kinds, plain and blurred (30 instantiations per S).
//
// Replaces the TPU kernel mtf_tpu/ops/pallas/lk_fused.py:_chain_kernel_one
// (any n_s, ch 1-4, kind linear / cubic / cubic_bspl, any blur; pallas_call
// at lk_fused.py:442). Contract, per tracker b:
//   inputs   win (C, Hc, Wc) f32 window (C = 1 outside the MC mode),
//            M0 (3, 3) window <- template-frame warp, gens (S, 3, 3) SSM
//            generators, ph (3, N) homogeneous base points, templ (C, N)
//            (NCC: the centred unit template n0), ESM only: j0 (S, N)
//            template-side pixel Jacobian
//   per point  the projected point, clamped to [0.001 + r, size - 1.001 - r]
//            (linear) or [1.001 + r, size - 2.001 - r] (cubic kinds), r the
//            blur radius (blur - 1 with blur > 1, else 0): the replicate
//            border, every tap inside the window; the dense tap weights
//            phi(t) and phi'(t) at t = k - x per axis (linear: 2 taps, the
//            derivative along an axis is 0 at an exactly integer
//            coordinate, as phi'(0) = 0 in the dense form; cubic: 4 taps,
//            phi' continuous; blurred: 2 + 2r or 4 + 2r taps, each weight
//            sum_i c_i phi(t - (i - r)) over the 2r + 1 binomial taps c);
//            (jx, jy) the quotient-rule Jacobian w.r.t. the S state
//            params, computed once per point; per channel c: (val_c, dx_c,
//            dy_c) from channel c's taps at the shared tap positions and
//            weights, Jm_c = dx_c jx + dy_c jy, with ESM Jm := (Jm + J0) / 2
//   outputs  val (C, N), and
//            SSD: g (S) = sum_c Jm_c (templ_c - val_c),
//                 h (S, S) = sum_c Jm_c Jm_c^T;
//            NCC: g (S) = a = Jm n0, h (S, S) = R = Jm Jm^T,
//                 mom (2, S) = [Jm val; Jm 1], scal (5) = (sum val,
//                 sum val^2, sum n0 val, live count, sum n0).
// The NCC gradient and selft Hessian are a nonlinear combine of these
// moments, done on the host side (ncc_combine in ops/kernels/lk_fused.py).
// The bfloat16-operand flag of `interp_bf16` is a build of its own
// (-DLK_BF16=1: the plain-tap instantiations only, each rounding every tap
// and derivative weight to bfloat16, dense_taps::tap_weight, from weights
// computed in the plain form's order; the caller rounds the window), as
// the JAX package's dense sampler with compute_dtype bfloat16 does; the
// build without it is unchanged.
//
// The TPU kernel's 128-row y-bands (and their in-band mask) and its pad
// lanes are layout artifacts: here the whole window is clamped (band == hc
// semantics) and a bounds check on N replaces padding, so every point is
// live and the live count is N. No point is ever dropped from a band, so
// the TPU kernel's ESM fault (lk_fused.py:317-322: the live mask is applied
// before the average, so an out-of-band point still adds J0 / 2) cannot
// occur here.
//
// Layout: one block of 1-8 warps per tracker (ops/kernels/lk_fused.py:
// block_warps: one warp per two 32-point chunks, so small N leaves room
// on the SM for more trackers); each warp takes 32 points at a time, one
// per lane, and loads the next chunk's point and template value while it
// works on this one. A lane projects its point, forms the warp Jacobian
// and samples the taps, then writes its row of the warp's tile in shared
// memory: Jm (S entries) and the vectors the sums need (SSD the residual
// t - v; NCC n0, v and 1). The warp then accumulates the tile's outer
// products on the tensor cores (tile_mma: D (16 x 8) += [Jm | vectors]
// Jm^T, four m16n8k8 TF32 products of 8 points, each split 3xTF32 for
// float32-class accuracy), so J^T J, g (NCC: a, Jm v, Jm 1) live in a
// 4-register fragment instead of 44 (SSD) or 65 (NCC) accumulators per
// thread; only NCC's 5 scalar moments stay per-lane sums. The warps' D
// fragments are summed in warp order through shared memory: a fixed
// summation order with no atomics, so results repeat. J^T J is D's upper
// triangle, mirrored. A point past N writes zeros, so it adds nothing to
// any sum (ESM: after the mean with J0), and NCC's live count stays N.
// j0 is laid out (B, S, N), so neighbouring lanes read neighbouring
// points of each row. The MC mode runs the tile and its products once
// per channel (no register grows with C); the channel count is a runtime
// loop, so one instantiation takes C = 1-4, and the single-channel modes
// keep C = 1 at compile time. The TPU kernel builds its (Wc, TN)
// tap-weight matrices once and shares them across channels; here the
// shared part is per point: projection, warp Jacobian, tap positions and
// weights once, then C times only the tap reads and the accumulation.
// The blurred mode (K4b, reached by no tracker: the trackers blur the
// frame once per stride instead) keeps no per-point weight arrays: each
// row's and each column's weight is summed over the binomial taps on the
// fly inside the tap loop, blur being a runtime argument; it is a
// separate template flag and kernel.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32), each input read once and
// each output written once: per tracker the window pixels the points' taps
// cover (at most C x the 144x144 f32 window, 83 KB per channel), the
// points (12 B/point), the template and val (4 B/point/channel each), with
// ESM j0 (4 S B/point); ~360 FLOPs per point for linear SSD at S = 8, ~700
// for cubic (4 + 4 weights of ~14 FLOPs, 16 taps x 3 sums per channel),
// plus ~130 per extra channel. At B = 1024, N = 2500, NCC + ESM, S = 8:
// ~85 MB of windows, 82 MB of j0, 31 MB of points, 10 + 10 MB of template
// and values, ~0.21 GB in all, ~0.06 ms; ~0.7 GFLOP is ~0.01 ms. Memory
// bounds every plain-tap mode; the blurred taps cost (2r + 1) tap
// evaluations per weight and ((2r + 2)^2 or (2r + 4)^2) weights per point
// and channel, which makes operations bound them from blur ~3 on.
// What held the kernel back, measured on an H100 80GB HBM3 at 700 W with
// ablations of the earlier design (one thread per point, S + S(S+1)/2
// float32 accumulators per thread, PERF.md §6): at S = 8 those
// accumulators took the thread to 180 registers, one 256-thread block per
// SM, which left the two dependent memory round trips of each point (its
// coordinates, then its tap gathers) exposed; without the J^T J sums K1
// ran 0.096 ms instead of 0.145, with the next point's loads in flight
// 0.114, and capped at 128 registers it spilled and gained nothing. The
// tensor-core tile takes the accumulators out of the registers (64-112
// at S = 8, 2-4 blocks per SM), and the prefetch covers the first round
// trip, and blocks sized to N let an SM hold several small-N trackers.
// K1 at B = 1280 then took 0.075 ms at N = 2500 (bound 0.0295), 0.028 at
// 625 and 0.008 at 169 (0.143, 0.057 and 0.026 before), on the same card.
// What bounds it now is the tap gathers' latency against the warps an SM
// holds, and the issue of the per-point work (projection, Jacobian, taps,
// tile and its products).
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "dense_taps.cuh"

namespace {

using dense_taps::cubic_axis;
using dense_taps::kBspl;
using dense_taps::kCubic;
using dense_taps::kLinear;
using dense_taps::linear_sample;

#ifndef LK_S
#define LK_S 8
#endif
#ifndef LK_BF16
#define LK_BF16 0
#endif

constexpr int kS = LK_S;                    // state dims (the SSM's DOF)
constexpr bool kBf16 = LK_BF16 != 0;        // the bfloat16-operand flag
constexpr int kMaxBlur = 8;                 // as MAX_BLUR in lk_fused.py
constexpr int kNScal = 5;                   // NCC scalar moments
constexpr int kMaxThreads = 256;            // a block is 1-8 warps
constexpr int kMaxWarps = kMaxThreads / 32;
// the per-warp tile of tile_mma: 16 rows (Jm's S, zero up to 8, then the
// vectors) x 32 points; a row stride of 36 floats makes the row writes
// (one point per lane) and the fragment reads (bank 4 grp + tig) free of
// bank conflicts
constexpr int kRows = 16;
constexpr int kTileStride = 36;
// dynamic shared memory per warp: its tile, its D (16 x 8) and its NCC
// scalars
constexpr int kWarpSmem = kRows * kTileStride + kRows * 8 + kNScal;

// One tap at offset t = k - x of `kKind` for the blurred mode: its weight
// phi(t) and its derivative with respect to x, -phi'(t) (linear: sign(t)
// inside |t| < 1, 0 at t = 0, as the dense form's phi'; cubic:
// dense_taps::cubic_tap).
template <int kKind>
__device__ __forceinline__ void plain_tap(float t, float& w, float& d) {
  if constexpr (kKind == kLinear) {
    const float a = fabsf(t);
    w = fmaxf(1.0f - a, 0.0f);
    d = a < 1.0f ? (t > 0.0f ? 1.0f : (t < 0.0f ? -1.0f : 0.0f)) : 0.0f;
  } else {
    dense_taps::cubic_tap<kKind>(t, w, d);
  }
}

// The binomially blurred tap: sum_i c_i tap(t - (i - r)), i = 0..2r, over
// the binomial taps c (`taps`, in shared memory), summed in i's order as
// the plain form does.
template <int kKind>
__device__ __forceinline__ void blurred_tap(float t, int r,
                                            const float* taps, float& w,
                                            float& d) {
  w = d = 0.0f;
  for (int i = 0; i <= 2 * r; ++i) {
    float wi, di;
    plain_tap<kKind>(t - (float)(i - r), wi, di);
    w += taps[i] * wi;
    d += taps[i] * di;
  }
}

// The tensor-core accumulation. One m16n8k8 TF32 product per 8 points:
// A (16 x 8) is the tile's 16 rows at those points, B (8 x 8) its first
// 8 rows (the Jm entries) transposed, so D (16 x 8) += [Jm | vectors]
// Jm^T over them. Each float x is split into big, x rounded to TF32's 10
// mantissa bits (to nearest, ties away, as cvt.rna: two integer
// operations), and small = x - big (exact), which the tensor core reads
// to 10 bits (|small| <= 2^-11 |x|, so x is kept to ~2^-21); D takes
// small_a big_b, big_a small_b, then big_a big_b (3xTF32: float32-class
// products, the small x small term below float32 rounding) and
// accumulates in float32 in a fixed order.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += tile rows x (its Jm rows)^T over the warp's 32 points (4 products
// of 8 points, in order). Fragment layout of m16n8k8 (grp = lane / 4,
// tig = lane % 4): a = A[grp][tig], A[grp + 8][tig], A[grp][tig + 4],
// A[grp + 8][tig + 4]; b = B[tig][grp], B[tig + 4][grp], which are a[0]
// and a[2] here; d = D[grp][2 tig], D[grp][2 tig + 1], D[grp + 8][2 tig],
// D[grp + 8][2 tig + 1].
__device__ __forceinline__ void tile_mma(const float (*t)[kTileStride],
                                         int grp, int tig, float (&d)[4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const int col = kc * 8 + tig;
    uint32_t big[4], small[4];
    split_tf32(t[grp][col], big[0], small[0]);
    split_tf32(t[grp + 8][col], big[1], small[1]);
    split_tf32(t[grp][col + 4], big[2], small[2]);
    split_tf32(t[grp + 8][col + 4], big[3], small[3]);
    mma_tf32(d, small, big[0], big[2]);
    mma_tf32(d, big, small[0], small[2]);
    mma_tf32(d, big, big[0], big[2]);
  }
}

// One block's whole iteration: the kernels below run it for one tracker.
template <bool kNcc, bool kEsm, bool kMc, int kKind, bool kBlur>
__device__ __forceinline__ void chain_iteration(
    const float* __restrict__ win, const float* __restrict__ m0,
    const float* __restrict__ gens, const float* __restrict__ ph,
    const float* __restrict__ templ, const float* __restrict__ j0,
    float* __restrict__ val, float* __restrict__ g_out,
    float* __restrict__ h_out, float* __restrict__ mom_out,
    float* __restrict__ scal_out, int hc, int wc, int n, int channels,
    int blur, int win_b) {
  constexpr bool kLin = kKind == kLinear;
  // the bfloat16-operand flag: the plain taps' weights rounded
  constexpr bool kWbf = kBf16 && !kBlur;
  // rows 0..2: M0; rows 3 + 3 s + r: row r of M0 G_s
  __shared__ float a_rows[3 + 3 * kS][3];
  // per warp (kWarpSmem floats each): tiles, then Ds, then NCC scalars
  extern __shared__ float warp_smem[];
  // blurred taps: C(2r, i) / 4^r, by Pascal's rule and halvings, so exact
  // in float32 as _binomial_taps' float32 taps are (no division, which
  // would be a call)
  __shared__ float btaps[2 * kMaxBlur - 1];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int lane = tid & 31, warp = tid >> 5;
  float (*tile)[kRows][kTileStride] =
      reinterpret_cast<float (*)[kRows][kTileStride]>(warp_smem);
  float (*red)[kRows * 8] = reinterpret_cast<float (*)[kRows * 8]>(
      warp_smem + nwarps * kRows * kTileStride);
  float (*red_s)[kNScal] = reinterpret_cast<float (*)[kNScal]>(
      warp_smem + nwarps * (kRows * kTileStride + kRows * 8));
  const int grp = lane >> 2, tig = lane & 3;
  const int nch = kMc ? channels : 1;
  const float* m = m0 + (size_t)b * 9;
  const int rad = kBlur ? blur - 1 : 0;
  if (kBlur && tid == 0) {
    btaps[0] = 1.0f;
    for (int i = 1; i <= 2 * rad; ++i) {
      btaps[i] = 0.0f;
      for (int k = i; k > 0; --k) btaps[k] = 0.5f * (btaps[k] + btaps[k - 1]);
      btaps[0] *= 0.5f;
    }
  }
  if (tid < 9) a_rows[tid / 3][tid % 3] = m[tid];
  for (int e = tid; e < kS * 9; e += nthreads) {
    const int s = e / 9, r = (e / 3) % 3, k = e % 3;
    const float* G = gens + s * 9;
    a_rows[3 + 3 * s + r][k] =
        m[r * 3 + 0] * G[0 * 3 + k] + m[r * 3 + 1] * G[1 * 3 + k] +
        m[r * 3 + 2] * G[2 * 3 + k];
  }
  // rows the points never write (S..7, and past the vectors) stay 0
  for (int e = tid; e < nwarps * kRows * kTileStride; e += nthreads)
    (&tile[0][0][0])[e] = 0.0f;
  __syncthreads();

  float (*t_w)[kTileStride] = tile[warp];
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};     // this warp's D fragment
  float sc[kNScal];                           // NCC scalar moments
#pragma unroll
  for (int i = 0; i < kNScal; ++i) sc[i] = 0.0f;

  const size_t plane = (size_t)hc * wc;
  const float* phb = ph + (size_t)b * 3 * n;
  const float* tb = templ + (size_t)b * nch * n;
  // win_b 0: one window (the shared frame) read by every tracker
  const float* wb = win + (size_t)(b * win_b) * nch * plane;
  const float* j0b = kEsm ? j0 + (size_t)b * kS * n : nullptr;
  float* vb = val + (size_t)b * nch * n;
  // clamp bounds rounded from double, as the plain form's scalars are;
  // blurred taps reach r more pixels on each side
  const float lo = kBlur ? (float)((kLin ? 0.001 : 1.001) + rad)
                         : (kLin ? 0.001f : 1.001f);
  const float hix = (float)((double)wc - (kLin ? 1.001 : 2.001) - rad);
  const float hiy = (float)((double)hc - (kLin ? 1.001 : 2.001) - rad);

  // The next chunk's point and (first) template value are loaded while
  // this one is processed. A point past N reads as (0, 0, 1): finite, its
  // taps inside the window, and every term it makes is set to 0.
  auto load_point = [&](int q, float& x, float& y, float& w, float& t) {
    const bool ok = q < n;
    x = ok ? phb[q] : 0.0f;
    y = ok ? phb[n + q] : 0.0f;
    w = ok ? phb[2 * n + q] : 1.0f;
    t = ok ? tb[q] : 0.0f;
  };
  float npx, npy, npw, nt;
  load_point(warp * 32 + lane, npx, npy, npw, nt);

  // each warp takes 32 points at a time, one per lane, its trip count the
  // same for every lane (mma needs the whole warp)
  for (int base = warp * 32; base < n; base += nthreads) {
    const int p = base + lane;
    const bool live = p < n;
    const float px = npx, py = npy, pw = npw, t_first = nt;
    load_point(p + nthreads, npx, npy, npw, nt);
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
    // blurred: the first tap and the tap count per axis
    const int first = (kLin ? 0 : -1) - rad;
    const int ntaps = (kLin ? 2 : 4) + 2 * rad;
    if constexpr (kBlur) {
      t0 = wb + (size_t)((int)floorf(y) + first) * wc +
           ((int)floorf(x) + first);
    } else if constexpr (kLin) {
      const float xf = floorf(x), yf = floorf(y);
      fx = x - xf;
      fy = y - yf;
      t0 = wb + (size_t)((int)yf) * wc + (int)xf;
    } else {
      cubic_axis<kKind, kWbf>(x, wx, dwx);
      cubic_axis<kKind, kWbf>(y, wy, dwy);
      t0 = wb + (size_t)((int)floorf(y) - 1) * wc + ((int)floorf(x) - 1);
    }

    for (int c = 0; c < nch; ++c) {
      const float* tc = t0 + c * plane;
      float v, dx, dy;
      if constexpr (kBlur) {
        // each row summed first, its weights and each column's summed
        // over the binomial taps on the fly
        v = dx = dy = 0.0f;
        const float fx0 = floorf(x) + (float)first;
        const float fy0 = floorf(y) + (float)first;
        for (int i = 0; i < ntaps; ++i) {
          const float* row = tc + i * wc;
          float rs = 0.0f, rd = 0.0f;
          for (int j = 0; j < ntaps; ++j) {
            float w, dd;
            blurred_tap<kKind>((fx0 + (float)j) - x, rad, btaps, w, dd);
            const float pix = row[j];
            rs += w * pix;
            rd += dd * pix;
          }
          float w, dd;
          blurred_tap<kKind>((fy0 + (float)i) - y, rad, btaps, w, dd);
          v += w * rs;
          dx += w * rd;
          dy += dd * rs;
        }
      } else if constexpr (kLin) {
        linear_sample<kWbf>(tc, wc, fx, fy, v, dx, dy);
      } else {
        // dense_taps::cubic_sample's sum, spelled out
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
      float t = t_first;
      if (live) {
        vb[(size_t)c * n + p] = v;
        if (c > 0) t = tb[(size_t)c * n + p];
      }
      // this point's rows of the tile: Jm (with ESM the mean with J0,
      // then masked), then the vectors; a point past N writes zeros
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        float jm = jx[s] * dx + jy[s] * dy;
        if constexpr (kEsm)
          jm = 0.5f * (jm + (live ? j0b[(size_t)s * n + p] : 0.0f));
        t_w[s][lane] = live ? jm : 0.0f;
      }
      if constexpr (kNcc) {
        t_w[8][lane] = live ? t : 0.0f;
        t_w[9][lane] = live ? v : 0.0f;
        t_w[10][lane] = live ? 1.0f : 0.0f;
        if (live) {
          sc[0] += v;
          sc[1] += v * v;
          sc[2] += t * v;
          sc[3] += 1.0f;
          sc[4] += t;
        }
      } else {
        t_w[8][lane] = live ? t - v : 0.0f;
      }
      __syncwarp();
      tile_mma(t_w, grp, tig, d);
      __syncwarp();
    }
  }

  // this warp's D, and (NCC) its scalars, to shared memory
  red[warp][grp * 8 + 2 * tig] = d[0];
  red[warp][grp * 8 + 2 * tig + 1] = d[1];
  red[warp][(grp + 8) * 8 + 2 * tig] = d[2];
  red[warp][(grp + 8) * 8 + 2 * tig + 1] = d[3];
  if constexpr (kNcc) {
#pragma unroll
    for (int i = 0; i < kNScal; ++i) {
      float v = sc[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red_s[warp][i] = v;
    }
  }
  __syncthreads();

  // D over the warps, in warp order: rows 0..S-1 x cols 0..S-1 are
  // Jm Jm^T (its upper triangle, mirrored), row 8 g (SSD) or a (NCC),
  // rows 9 and 10 [Jm v; Jm 1]
  for (int e = tid; e < kRows * 8 + (kNcc ? kNScal : 0); e += nthreads) {
    float s = 0.0f;
    if (e < kRows * 8) {
      const int row = e >> 3, col = e & 7;
      for (int w = 0; w < nwarps; ++w) s += red[w][e];
      if (row < kS && col < kS && row <= col) {
        float* h = h_out + (size_t)b * kS * kS;
        h[row * kS + col] = s;
        h[col * kS + row] = s;
      } else if (col < kS && row == 8) {
        g_out[(size_t)b * kS + col] = s;
      } else if (kNcc && col < kS && (row == 9 || row == 10)) {
        mom_out[(size_t)b * 2 * kS + (row - 9) * kS + col] = s;
      }
    } else {
      const int i = e - kRows * 8;
      for (int w = 0; w < nwarps; ++w) s += red_s[w][i];
      scal_out[(size_t)b * kNScal + i] = s;
    }
  }
}

#define CHAIN_PARAMS                                                        \
  const float* __restrict__ win, const float* __restrict__ m0,              \
      const float* __restrict__ gens, const float* __restrict__ ph,         \
      const float* __restrict__ templ, const float* __restrict__ j0,        \
      float* __restrict__ val, float* __restrict__ g_out,                   \
      float* __restrict__ h_out, float* __restrict__ mom_out,               \
      float* __restrict__ scal_out, int hc, int wc, int n, int channels,    \
      int blur, int win_b
#define CHAIN_ARGS                                                          \
  win, m0, gens, ph, templ, j0, val, g_out, h_out, mom_out, scal_out, hc,   \
      wc, n, channels, blur, win_b

// Register budgets of the plain taps, by class (ptxas's own budget took
// 64 or 80 registers and spilled a few bytes in the classes below it,
// PERF.md §6): linear taps without ESM keep ptxas's own (48-64
// registers, four blocks of 8 warps per SM); ESM at S = 8, ESM with
// linear taps and SSD (one channel or several) with cubic taps ask for
// three blocks, at most 80 registers (ESM at S = 8 ran 13-22% faster
// there than on its own budget); NCC, and ESM below S = 8, with cubic
// taps ask for two, at most 128. The blurred taps' runtime tap loops made
// ptxas trade registers for occupancy and spill (capped at 64 or 128
// registers), so their kernel asks for one block per SM, which leaves it
// all 255 registers.
template <bool kNcc, bool kEsm, int kKind>
constexpr int min_blocks() {
  // the bfloat16 build's cubic weights (each operation rounded on its own,
  // then to bfloat16) spilled at three blocks: two, at most 128 registers,
  // and with ESM's J0 one (it spilled at 128)
  if (kBf16 && kKind != kLinear) return kEsm ? 1 : 2;
  if (kKind == kLinear && !kEsm) return 0;              // ptxas's own
  if (kEsm && kS == 8) return 3;
  if (kKind != kLinear && (kNcc || kEsm)) return 2;
  return 3;
}

template <bool kNcc, bool kEsm, bool kMc, int kKind>
__global__ void __launch_bounds__(kMaxThreads)
lk_fused_chain_kernel(CHAIN_PARAMS) {
  chain_iteration<kNcc, kEsm, kMc, kKind, false>(CHAIN_ARGS);
}

template <bool kNcc, bool kEsm, bool kMc, int kKind>
__global__ void __launch_bounds__(kMaxThreads, 3)
lk_fused_chain_kernel_3(CHAIN_PARAMS) {
  chain_iteration<kNcc, kEsm, kMc, kKind, false>(CHAIN_ARGS);
}

template <bool kNcc, bool kEsm, bool kMc, int kKind>
__global__ void __launch_bounds__(kMaxThreads, 2)
lk_fused_chain_kernel_2(CHAIN_PARAMS) {
  chain_iteration<kNcc, kEsm, kMc, kKind, false>(CHAIN_ARGS);
}

template <bool kNcc, bool kEsm, bool kMc, int kKind>
__global__ void __launch_bounds__(kMaxThreads, 1)
lk_fused_chain_kernel_1(CHAIN_PARAMS) {
  chain_iteration<kNcc, kEsm, kMc, kKind, false>(CHAIN_ARGS);
}

template <bool kNcc, bool kEsm, bool kMc, int kKind>
__global__ void __launch_bounds__(kMaxThreads, 1)
lk_fused_chain_blur_kernel(CHAIN_PARAMS) {
  chain_iteration<kNcc, kEsm, kMc, kKind, true>(CHAIN_ARGS);
}

#undef CHAIN_ARGS
#undef CHAIN_PARAMS

struct Args {
  const float *win, *m0, *gens, *ph, *templ, *j0;
  float *val, *g, *h, *mom, *scal;
  int batch, hc, wc, n, channels, blur, warps, win_b;
  cudaStream_t stream;
};

template <bool kNcc, bool kEsm, bool kMc, int kKind, bool kBlur>
void launch(const Args& a) {
  const unsigned threads = 32u * a.warps;
  const size_t smem = sizeof(float) * kWarpSmem * a.warps;
#define CHAIN_LAUNCH(kernel)                                                \
  kernel<kNcc, kEsm, kMc, kKind><<<a.batch, threads, smem, a.stream>>>(     \
      a.win, a.m0, a.gens, a.ph, a.templ, a.j0, a.val, a.g, a.h, a.mom,     \
      a.scal, a.hc, a.wc, a.n, a.channels, a.blur, a.win_b)
  // only the kernel that runs is instantiated
  constexpr int kMin = min_blocks<kNcc, kEsm, kKind>();
  if constexpr (kBlur)
    CHAIN_LAUNCH(lk_fused_chain_blur_kernel);
  else if constexpr (kMin == 3)
    CHAIN_LAUNCH(lk_fused_chain_kernel_3);
  else if constexpr (kMin == 2)
    CHAIN_LAUNCH(lk_fused_chain_kernel_2);
  else if constexpr (kMin == 1)
    CHAIN_LAUNCH(lk_fused_chain_kernel_1);
  else
    CHAIN_LAUNCH(lk_fused_chain_kernel);
#undef CHAIN_LAUNCH
}

// the five modes of one tap kind; false where there is no instantiation
template <int kKind, bool kBlur>
bool launch_mode(const Args& a, int ncc, int esm, int mc) {
  if (mc) {
    if (ncc || esm) return false;
    launch<false, false, true, kKind, kBlur>(a);
  } else if (ncc && esm) {
    launch<true, true, false, kKind, kBlur>(a);
  } else if (ncc) {
    launch<true, false, false, kKind, kBlur>(a);
  } else if (esm) {
    launch<false, true, false, kKind, kBlur>(a);
  } else {
    launch<false, false, false, kKind, kBlur>(a);
  }
  return true;
}

// (the bfloat16 build instantiates the plain taps only)
template <int kKind>
bool launch_kind(const Args& a, int ncc, int esm, int mc) {
  if constexpr (kBf16)
    return a.blur > 1 ? false : launch_mode<kKind, false>(a, ncc, esm, mc);
  else
    return a.blur > 1 ? launch_mode<kKind, true>(a, ncc, esm, mc)
                      : launch_mode<kKind, false>(a, ncc, esm, mc);
}

}  // namespace

// Plain C entry point of this library's S (bound with ctypes). All
// pointers are device pointers to contiguous float32 tensors; gens is
// (S, 3, 3), j0 (B, S, N) is read only when esm != 0, mom and scal are
// written only when ncc != 0 (null otherwise). `channels` is C (1-4) with
// mc != 0 and 1 otherwise; `kind` is 0 linear, 1 cubic, 2 cubic_bspl;
// `blur` 0 or 1 samples with plain taps, 2-8 with the binomially blurred
// ones (the window must hold their 2 blur or 2 blur + 2 taps per axis);
// `warps` (1-8) the warps of each tracker's block
// (ops/kernels/lk_fused.py:block_warps picks it); `shared` != 0 reads one
// window (C, Hc, Wc) for every tracker in place of B; `bf16` must be this
// build's flag (LK_BF16: 1 rounds the plain taps' weights to bfloat16, the
// window holding values the caller rounded). `stream` is the caller's CUDA
// stream. Returns cudaErrorInvalidValue, launching nothing,
// for a combination without an instantiation or a block size out of
// range, else cudaGetLastError() after the launch.
extern "C" int lk_fused_chain_launch(const void* win, const void* m0,
                                     const void* gens, const void* ph,
                                     const void* templ, const void* j0,
                                     void* val, void* g, void* h, void* mom,
                                     void* scal, int batch, int hc, int wc,
                                     int n, int channels, int ncc, int esm,
                                     int mc, int kind, int blur, int warps,
                                     int shared, int bf16, void* stream) {
  const Args a{(const float*)win, (const float*)m0, (const float*)gens,
               (const float*)ph, (const float*)templ, (const float*)j0,
               (float*)val, (float*)g, (float*)h, (float*)mom,
               (float*)scal, batch, hc, wc, n, mc ? channels : 1, blur,
               warps, shared ? 0 : 1, (cudaStream_t)stream};
  if (channels < 1 || channels > 4 || blur < 0 || blur > kMaxBlur ||
      warps < 1 || warps > kMaxWarps || (bf16 != 0) != kBf16)
    return (int)cudaErrorInvalidValue;
  bool ok = false;
  if (kind == kLinear)
    ok = launch_kind<kLinear>(a, ncc, esm, mc);
  else if (kind == kCubic)
    ok = launch_kind<kCubic>(a, ncc, esm, mc);
  else if (kind == kBspl)
    ok = launch_kind<kBspl>(a, ncc, esm, mc);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
