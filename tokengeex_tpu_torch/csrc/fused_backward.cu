// Vocabulary probe fused with the backward (log-sum-exp) DP, for Hopper
// (sm_90a): the betas of the session's fused E-step.
//
// Replaces: tokengeex_tpu/ops/lattice_pallas_fused.py `fused_backward_chunk`
// (`_make_fused_bwd_kernel`).
//
// What it computes, per packed row, walking byte positions q from W-1 down
// to 0 (token of length l = j+1 STARTING at q, i.e. ending at dp index q+l;
// hist[j] = beta at dp index q+1+j):
//   fp     = (P[q+l] - P[q]) * rinv[q]                  (two hash families)
//   score  = the probe of fused_probe.cuh (T1 over T2, the empty-slot
//            guard, a hit above NEG / 2);
//   fr     = run length STARTING at q with no internal sample start:
//            fr = inb(q) ? 1 + (is_start[q+1] ? 0 : fr(q+1)) : 0;
//   valid  = l <= fr, and, with dropout, the coin u = (du[q] * odd_l) >>> 1
//            is not below thr >>> 1 (l > 1): keyed on the token's start;
//   cand[j] = score + hist[j];  m = max;  has = m > NEG/2;  safe = has ? m : 0
//   beta   = has ? safe + logf(sum_j expf(cand[j] - safe)) : NEG  (j ascending)
//   out[q] = end[q] ? 0 : beta;  hist <- [out[q], hist[0], ..., hist[L-2]]
// hist starts as [end[W] ? 0 : NEG, NEG, ...]. expf/logf are the
// full-precision library functions (no fast math).
//
// The design mirrors fused_forward.cu's `fused_forward_scan_kernel`:
//   - Chains. A row is cut at seg[k, r] (ops/lattice.py `chain_bounds`:
//     the first sample end or padding byte at or after k * S). Chain k
//     walks [seg[k], seg[k+1]) downwards; every token reaching across its
//     top bound is invalid (l > fr), so it starts from [0, NEG, ...] with
//     fr = inb ? 1 : 0 at its top byte, the row's last chain from
//     [end[W] ? 0 : NEG, NEG, ...]. seg == null is one chain per row.
//   - Lanes. A chain's L lengths on a group of G lanes (scan_lanes.cuh),
//     32 / G rows of one segment per warp in lockstep, the max by shuffles,
//     the sum in ascending j through shared memory.
//   - Hash histories. A step loads the start words of its byte, the same
//     address on every lane of a group (P[q] of both families, rinv[q],
//     du[q], the sample id, the flags), and rolls the prefix hashes down
//     its lanes: lane j holds the end hash P[q+1+j].
//   - The probe ahead of the recurrence: stream words 2D steps ahead, table
//     rows D steps ahead, in register rings (TGX_FUSED_D).
//   - Tables from global memory (L2, then L1), as the forward's.
//
// What bounds it on the H100: the recurrence, as the forward's; the
// streams are ~18 bytes per (position, row) read once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tokengeex_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "fused_probe.cuh"

template <int LMAX, int G, bool DROP>
__global__ void __launch_bounds__(32) fused_backward_scan_kernel(
    const int2* __restrict__ t1,         // (H,) rows [check, f32 score bits]
    const int2* __restrict__ t2,         // (H,)
    const int32_t* __restrict__ p1,      // (pad + W + 1 + pad, B) prefix hashes R1
    const int32_t* __restrict__ p2,      // same for R2
    const int32_t* __restrict__ rinv1,   // (pad + W,) inverse powers R1
    const int32_t* __restrict__ rinv2,   // (pad + W,)
    const int32_t* __restrict__ sid,     // (pad + W + pad, B) sample ids, < 0 outside
    const uint8_t* __restrict__ is_start,// (W + 1, B)
    const uint8_t* __restrict__ is_end,  // (W + 1, B)
    const int32_t* __restrict__ du,      // (pad + W + pad, B) dropout words (DROP only)
    const int32_t* __restrict__ seg,     // (K+1, B) chain bounds, or null (K = 1)
    float* __restrict__ betas,           // (W, B) post-reset betas
    int W, int L, int B, int K, int pad, int bits, uint32_t thr_half) {
  constexpr int P = LMAX / G;   // lengths per lane: j = g + G * p
  constexpr int CH = 32 / G;    // chains (rows) per warp
  constexpr int D = TGX_FUSED_D;
  // By step parity (one barrier a step), rows 16-byte aligned.
  __shared__ __align__(16) float e_s[2][CH][SumRow<LMAX>::stride];
  const int lane = threadIdx.x;
  const int g = lane % G;
  const int c = lane / G;
  const int groups = (B + CH - 1) / CH;
  const int unit = blockIdx.x;  // (segment, 32/G rows) of this warp
  const int k = unit / groups;
  const int r = (unit % groups) * CH + c;
  const bool row = r < B && k < K;
  const int rr = row ? r : 0;  // lanes without a row load row 0's words
  const size_t Bs = (size_t)B;
  const int shift = 32 - bits;

  // This lane's chain [b0, b1), walked downwards from b1 - 1.
  int b0 = INT_MAX, b1 = INT_MAX;
  if (row) tgx_chain(seg, k, r, Bs, W, b0, b1);
  const int lo = __reduce_min_sync(TGX_FULL, b0);
  const int hi = __reduce_max_sync(TGX_FULL, row ? b1 : INT_MIN);
  if (lo >= hi) return;

  // Stream ring: the start words of step t, loaded 2D steps ahead.
  uint32_t ss1[D], ss2[D], sr1[D], sr2[D], sdu[DROP ? D : 1];
  int32_t ssid[D];
  uint8_t snx[D], sen[D];
  auto fetch = [&](int i, int t) {
    if (t >= lo) {
      const size_t pt = (size_t)(pad + t);
      ss1[i] = (uint32_t)p1[pt * Bs + rr];
      ss2[i] = (uint32_t)p2[pt * Bs + rr];
      sr1[i] = (uint32_t)rinv1[pt];
      sr2[i] = (uint32_t)rinv2[pt];
      if constexpr (DROP) sdu[i] = (uint32_t)du[pt * Bs + rr];
      ssid[i] = sid[pt * Bs + rr];
      snx[i] = is_start[(size_t)(t + 1) * Bs + rr];
      sen[i] = is_end[(size_t)t * Bs + rr];
    }
  };

  // The probe's state one step behind its next step t (descending): lane
  // j holds the end hash P[t+2+j] (clamped to the padded rows), every lane
  // P[t+1] and the run length at t + 1.
  const size_t last = (size_t)(2 * pad + W);
  uint32_t ph1[P], ph2[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const size_t i0 = (size_t)(pad + hi + 1 + g + G * p);
    const size_t ix = i0 < last ? i0 : last;
    ph1[p] = (uint32_t)p1[ix * Bs + rr];
    ph2[p] = (uint32_t)p2[ix * Bs + rr];
  }
  uint32_t pin1 = (uint32_t)p1[(size_t)(pad + hi) * Bs + rr];
  uint32_t pin2 = (uint32_t)p2[(size_t)(pad + hi) * Bs + rr];
  int fr = 0;

  // Probe ring: step t's gathered rows, check words, validity bits and end flag.
  int2 g1[D][P], g2[D][P];
  uint32_t gf[D][P], gok[D];
  bool gen[D];
  auto probe = [&](int i, int t) {
    tgx_roll<LMAX, G>(ph1, pin1, g);
    tgx_roll<LMAX, G>(ph2, pin2, g);
    // A chain's top byte is followed by a sample end or padding: fr
    // restarts there.
    const bool fresh = snx[i] != 0 || t == b1 - 1;
    fr = (ssid[i] >= 0) ? 1 + (fresh ? 0 : fr) : 0;
    pin1 = ss1[i];
    pin2 = ss2[i];
    const uint32_t rv1 = sr1[i], rv2 = sr2[i];
    uint32_t ok = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int j = g + G * p;
      const uint32_t l = (uint32_t)(j + 1);
      const uint32_t fp1 = (ph1[p] - pin1) * rv1;
      const uint32_t fp2 = (ph2[p] - pin2) * rv2;
      g1[i][p] = __ldg(t1 + tgx_slot1(fp1, l, shift));
      g2[i][p] = __ldg(t2 + tgx_slot2(fp2, l, shift));
      gf[i][p] = tgx_check(fp1, fp2);
      bool v = j < L && (int)l <= fr;
      if constexpr (DROP) v = v && !tgx_dropped(sdu[i], j, thr_half);
      ok |= (uint32_t)v << p;
    }
    gok[i] = ok;
    gen[i] = sen[i] != 0;
  };

  // The history, as `tgx_lse_step` keeps it.
  float h[P], hx[P];
#pragma unroll
  for (int p = 0; p < P; ++p) h[p] = hx[p] = TGX_NEG;
  float h0 = TGX_NEG;  // hist[0], on every lane of the group

#pragma unroll
  for (int i = 0; i < D; ++i) fetch(i, hi - 1 - i);
#pragma unroll
  for (int i = 0; i < D; ++i) probe(i, hi - 1 - i);
#pragma unroll
  for (int i = 0; i < D; ++i) fetch(i, hi - 1 - D - i);

  for (int q0 = hi - 1; q0 >= lo; q0 -= D) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int q = q0 - i;
      if (q < lo) break;  // uniform over the warp
      if (q == b1 - 1) {  // chain start: the row's end, or a reset's
        const float top = (b1 == W)
            ? (is_end[(size_t)W * Bs + r] != 0 ? 0.0f : TGX_NEG) : 0.0f;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          h[p] = (g + G * p == 0) ? top : TGX_NEG;
          hx[p] = h[p];
        }
        h0 = top;
      }
      float sc[P];
#pragma unroll
      for (int p = 0; p < P; ++p)
        sc[p] = tgx_probe_score(g1[i][p], g2[i][p], gf[i][p],
                                (gok[i] >> p) & 1u);
      // The length-1 score, from the group's lane 0, on every lane.
      const float s0 = (G == 1) ? sc[0] : __shfl_sync(TGX_FULL, sc[0], 0, G);
      const float lse = tgx_lse_step<LMAX, G>(
          h, hx, h0, sc, s0, gen[i], &e_s[q & 1][c][0], g, L);
      if (g == 0 && q >= b0 && q < b1)
        betas[(size_t)q * Bs + r] = gen[i] ? 0.0f : lse;
      probe(i, q - D);  // the slot is consumed: refill both rings
      fetch(i, q - 2 * D);
    }
  }
}

template <int LMAX, int G>
static int launch(bool drop, const int2* t1, const int2* t2,
                  const int32_t* p1, const int32_t* p2, const int32_t* rinv1,
                  const int32_t* rinv2, const int32_t* sid,
                  const uint8_t* is_start, const uint8_t* is_end,
                  const int32_t* du, const int32_t* seg, float* betas, int W,
                  int L, int B, int K, int pad, int bits, uint32_t thr_half,
                  cudaStream_t stream) {
  const int units = K * ((B + 32 / G - 1) / (32 / G));  // warp per (segment, 32/G rows)
  auto kernel = drop ? fused_backward_scan_kernel<LMAX, G, true>
                     : fused_backward_scan_kernel<LMAX, G, false>;
  kernel<<<units, 32, 0, stream>>>(t1, t2, p1, p2, rinv1, rinv2, sid,
                                   is_start, is_end, du, seg, betas, W, L, B,
                                   K, pad, bits, thr_half);
  return (int)cudaGetLastError();
}

// Rows cut into K chains at seg (null: K = 1). du may be null when drop ==
// 0. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tgx_fused_backward(
    const int32_t* t1, const int32_t* t2, const int32_t* p1, const int32_t* p2,
    const int32_t* rinv1, const int32_t* rinv2, const int32_t* sid,
    const uint8_t* is_start, const uint8_t* is_end, const int32_t* du,
    const int32_t* seg, float* betas, int W, int L, int B, int K, int pad,
    int bits, int drop, unsigned int thr_half, void* stream) {
  const int2* x = reinterpret_cast<const int2*>(t1);
  const int2* y = reinterpret_cast<const int2*>(t2);
#define TGX_LAUNCH(LM, GG)                                                    \
  return launch<LM, GG>(drop != 0, x, y, p1, p2, rinv1, rinv2,     \
                        sid, is_start, is_end, du, seg, betas, W, L, B, K,    \
                        pad, bits, thr_half, (cudaStream_t)stream)
  TGX_SCAN_DISPATCH(L, TGX_LAUNCH);
#undef TGX_LAUNCH
}
