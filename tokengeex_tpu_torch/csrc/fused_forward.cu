// Vocabulary probe fused with the forward DP (Viterbi max or log-sum-exp),
// for Hopper (sm_90a).
//
// Replaces: tokengeex_tpu/ops/lattice_pallas_fused.py `fused_forward_chunk`
// with kind="viterbi" and kind="logsumexp" (`_make_fused_fwd_kernel`,
// `_probe_tiles`, `_tile_consts`).
//
// What it computes, per packed row and dp step q (token of length l = j+1
// ending at dp index q+1, i.e. starting at byte s = q - j):
//   fp     = (P[q+1] - P[s]) * rinv[s]                  (two hash families)
//   score  = the probe of fused_probe.cuh (T1 over T2, the empty-slot
//            guard, a hit above NEG / 2);
//   valid  = l <= run length of the sample at q, and, with dropout, the
//            coin u = (du[s] * odd_l) >>> 1 is not below thr >>> 1 (l > 1);
//   then the Viterbi relaxation of viterbi_chunk.cu (dp and best_l out,
//   the max-plus step `tgx_max_step`), or the log-sum-exp step of
//   forward_chunk.cu (m = max cand, has = m > NEG/2, a = has ? m +
//   logf(sum expf(cand - m)) : NEG, the forward values a out, the sum in
//   ascending j; `tgx_lse_step`). Either carries 0 at a sample start.
//   rl = inb ? (start ? 1 : rl + 1) : 0 is the run length.
//
// One kernel for both kinds, `fused_forward_scan_kernel` (encode and the
// frequency pass take the Viterbi kind, the session's E-step the
// log-sum-exp kind), a chained, lane-parallel scan:
//   - Chains. A row is cut at seg[k, r] (ops/lattice.py `chain_bounds`:
//     the first sample start or padding byte at or after k * S): every
//     token reaching back across such a byte is invalid (l > rl), so the
//     history older than the bound meets only NEG scores (it adds expf(.)
//     = 0 exactly, and no masked candidate exceeds a valid one or enters
//     best_l: viterbi_chunk.cu), and rl restarts there from its own byte.
//     Chain
//     0 starts from hist_in / rl_in, every other from [0, NEG, ...] with rl
//     rebuilt at its first byte. seg == null is one chain per row. The
//     history out is not written: a chain's history at the width misses
//     the values before its start, so the wrappers rebuild it from the
//     values (ops/lattice_cuda_fused.py `_hist_from_values`).
//   - Lanes. A chain's L lengths sit on a group of G lanes (scan_lanes.cuh,
//     one length per lane at L <= 16 with G = 16), 32 / G rows of one
//     segment per warp walking their chains in lockstep. Each lane forms
//     its own token's fingerprint, slots and coin; the max goes by shuffles
//     and the sum in ascending j through shared memory, as the twins add;
//     the Viterbi kind's longest length on the max by one ballot.
//   - Hash histories. A step loads one new word per stream, the same
//     address on every lane of a group (P[q+1] of both families, rinv[q],
//     du[q], the sample id and the start flags), and rolls the prefix
//     hashes, inverse powers and dropout words down its lanes
//     (`tgx_roll`): lane j holds P[q-j], rinv[q-j] and du[q-j] without a
//     strided reload.
//   - The probe ahead of the recurrence. Stream words are loaded 2D steps
//     ahead and the table rows gathered D steps ahead (TGX_FUSED_D), both
//     into register rings; the hash roll and the run length run with the
//     probe. Between two steps only the max's butterfly, the
//     expf / sum / logf and the history shift remain (the Viterbi kind:
//     the length-1 candidate and a few selects); the score select and the
//     length-1 score's broadcast are off that path.
//   - No branch inside a step. The chain start is a select, loads past the
//     width read its last byte's words, and only the last partial ring of
//     steps is guarded, so the compiler overlaps neighbouring steps across
//     the unrolled rings (the Viterbi kind 1.8x faster than with a branch
//     per step, PERF.md).
//   - Tables from global memory (L2, then L1). Staging them into shared
//     memory per block (experiments/torch_fused_smem.cu) was timed slower
//     at the session's shape (PERF.md).
//
// What bounds it on the H100: the recurrence. The streams are ~17 bytes
// per (position, row) read once (~0.03 ms for a 8192 x 512 group at 3.35
// TB/s); a step needs the step before, so the floor is the longest chain
// a warp walks times one step's latency. The probe adds 2 * L random
// 8-byte table-row reads per (position, row), served from L1 / L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tokengeex_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "fused_probe.cuh"

template <int LMAX, int G, bool DROP, bool VIT>
__global__ void __launch_bounds__(32) fused_forward_scan_kernel(
    const int2* __restrict__ t1,         // (H,) rows [check, f32 score bits]
    const int2* __restrict__ t2,         // (H,)
    const int32_t* __restrict__ p1,      // (pad + W + 1 + pad, B) prefix hashes R1
    const int32_t* __restrict__ p2,      // same for R2
    const int32_t* __restrict__ rinv1,   // (pad + W,) inverse powers R1
    const int32_t* __restrict__ rinv2,   // (pad + W,)
    const int32_t* __restrict__ sid,     // (pad + W + pad, B) sample ids, < 0 outside
    const uint8_t* __restrict__ is_start,// (W + 1, B)
    const int32_t* __restrict__ du,      // (pad + W + pad, B) dropout words (DROP only)
    const float* __restrict__ hist_in,   // (L, B)
    const int32_t* __restrict__ rl_in,   // (B,)
    const int32_t* __restrict__ seg,     // (K+1, B) chain starts, or null (K = 1)
    float* __restrict__ a,               // (W, B) dp (VIT) or forward values
    int32_t* __restrict__ best_l,        // (W, B), VIT only
    int32_t* __restrict__ rl_out,        // (B,) run length after byte W - 1
    int W, int L, int B, int K, int pad, int bits, uint32_t thr_half) {
  constexpr int P = LMAX / G;   // lengths per lane: j = g + G * p
  constexpr int CH = 32 / G;    // chains (rows) per warp
  constexpr int D = TGX_FUSED_D;
  // The log-sum-exp sum's rows, by step parity (one barrier a step), rows
  // 16-byte aligned; the Viterbi kind does not use them.
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

  // This lane's chain [b0, b1); the warp walks the union of its chains'.
  int b0 = INT_MAX, b1 = INT_MAX;
  if (row) tgx_chain(seg, k, r, Bs, W, b0, b1);
  const int lo = __reduce_min_sync(TGX_FULL, b0);
  const int hi = __reduce_max_sync(TGX_FULL, row ? b1 : INT_MIN);
  if (lo >= hi) return;

  // Stream ring: the words of step t, loaded 2D steps ahead. Steps past
  // the width read its last byte's, so no load is guarded by a branch.
  uint32_t se1[D], se2[D], sr1[D], sr2[D], sdu[DROP ? D : 1];
  int32_t ssid[D];
  uint8_t sst[D], snx[D];
  auto fetch = [&](int i, int t) {
    const int tc = min(t, W - 1);
    const size_t pt = (size_t)(pad + tc);
    se1[i] = (uint32_t)p1[(pt + 1) * Bs + rr];
    se2[i] = (uint32_t)p2[(pt + 1) * Bs + rr];
    sr1[i] = (uint32_t)rinv1[pt];
    sr2[i] = (uint32_t)rinv2[pt];
    if constexpr (DROP) sdu[i] = (uint32_t)du[pt * Bs + rr];
    ssid[i] = sid[pt * Bs + rr];
    sst[i] = is_start[(size_t)tc * Bs + rr];
    snx[i] = is_start[(size_t)(tc + 1) * Bs + rr];
  };

  // The probe's state one step behind its next step t: lane j holds
  // P[t-1-j], rinv[t-1-j] and du[t-1-j] (padded rows), every lane P[t]
  // and the run length at t - 1.
  uint32_t ph1[P], ph2[P], rv1[P], rv2[P], dh[DROP ? P : 1];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i0 = pad + lo - 1 - (g + G * p);
    const size_t ix = (size_t)(i0 > 0 ? i0 : 0);
    ph1[p] = (uint32_t)p1[ix * Bs + rr];
    ph2[p] = (uint32_t)p2[ix * Bs + rr];
    rv1[p] = (uint32_t)rinv1[ix];
    rv2[p] = (uint32_t)rinv2[ix];
    if constexpr (DROP) dh[p] = (uint32_t)du[ix * Bs + rr];
  }
  uint32_t pe1 = (uint32_t)p1[(size_t)(pad + lo) * Bs + rr];
  uint32_t pe2 = (uint32_t)p2[(size_t)(pad + lo) * Bs + rr];
  int rl = (lo == 0) ? rl_in[rr] : 0;

  // Probe ring: step t's gathered rows, check words, validity bits and reset flag.
  int2 g1[D][P], g2[D][P];
  uint32_t gf[D][P], gok[D];
  bool grs[D];
  auto probe = [&](int i, int t) {
    tgx_roll<LMAX, G>(ph1, pe1, g);
    tgx_roll<LMAX, G>(ph2, pe2, g);
    tgx_roll<LMAX, G>(rv1, sr1[i], g);
    tgx_roll<LMAX, G>(rv2, sr2[i], g);
    if constexpr (DROP) tgx_roll<LMAX, G>(dh, sdu[i], g);
    // A chain's first byte is a sample start or padding: rl restarts.
    const bool fresh = sst[i] != 0 || (t == b0 && b0 > 0);
    rl = (ssid[i] >= 0) ? (fresh ? 1 : rl + 1) : 0;
    if (t == W - 1 && b1 == W && b0 < W && g == 0) rl_out[r] = rl;
    pe1 = se1[i];
    pe2 = se2[i];
    uint32_t ok = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int j = g + G * p;
      const uint32_t l = (uint32_t)(j + 1);
      const uint32_t fp1 = (pe1 - ph1[p]) * rv1[p];
      const uint32_t fp2 = (pe2 - ph2[p]) * rv2[p];
      g1[i][p] = __ldg(t1 + tgx_slot1(fp1, l, shift));
      g2[i][p] = __ldg(t2 + tgx_slot2(fp2, l, shift));
      gf[i][p] = tgx_check(fp1, fp2);
      bool v = j < L && (int)l <= rl;
      if constexpr (DROP) v = v && !tgx_dropped(dh[p], j, thr_half);
      ok |= (uint32_t)v << p;
    }
    gok[i] = ok;
    grs[i] = snx[i] != 0;
  };

  // The history, as `tgx_lse_step` and `tgx_max_step` keep it, and the
  // one it takes at the chain's first step: the row's (chain 0) or a
  // reset's.
  float h[P], hx[P], hs[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = g + G * p;
    h[p] = hx[p] = TGX_NEG;
    hs[p] = (j >= L) ? TGX_NEG
          : (b0 == 0) ? hist_in[j * Bs + rr]
          : (j == 0 ? 0.0f : TGX_NEG);
  }
  float h0 = TGX_NEG;  // hist[0], on every lane of the group
  const float hs0 = (b0 == 0) ? hist_in[rr] : 0.0f;

  // One step, branch-free, so that the compiler can overlap a step's
  // shuffles with its neighbours' across the unrolled rings.
  auto step = [&](int i, int q) {
    const bool start = q == b0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      h[p] = start ? hs[p] : h[p];
      hx[p] = start ? hs[p] : hx[p];
    }
    h0 = start ? hs0 : h0;
    float sc[P];
#pragma unroll
    for (int p = 0; p < P; ++p)
      sc[p] = tgx_probe_score(g1[i][p], g2[i][p], gf[i][p],
                              (gok[i] >> p) & 1u);
    // The length-1 score, from the group's lane 0, on every lane.
    const float s0 = (G == 1) ? sc[0] : __shfl_sync(TGX_FULL, sc[0], 0, G);
    const bool mine = g == 0 && q >= b0 && q < b1;
    if constexpr (VIT) {
      int bl;
      const float v =
          tgx_max_step<LMAX, G>(h, hx, h0, sc, s0, grs[i], g, L, bl);
      if (mine) {
        a[(size_t)q * Bs + r] = v;
        best_l[(size_t)q * Bs + r] = bl;
      }
    } else {
      const float lse = tgx_lse_step<LMAX, G>(
          h, hx, h0, sc, s0, grs[i], &e_s[q & 1][c][0], g, L);
      if (mine) a[(size_t)q * Bs + r] = lse;
    }
    probe(i, q + D);  // the slot is consumed: refill both rings
    fetch(i, q + 2 * D);
  };

#pragma unroll
  for (int i = 0; i < D; ++i) fetch(i, lo + i);
#pragma unroll
  for (int i = 0; i < D; ++i) probe(i, lo + i);
#pragma unroll
  for (int i = 0; i < D; ++i) fetch(i, lo + D + i);

  int q0 = lo;
  for (; q0 + D <= hi; q0 += D) {
#pragma unroll
    for (int i = 0; i < D; ++i) step(i, q0 + i);
  }
#pragma unroll
  for (int i = 0; i < D; ++i)
    if (q0 + i < hi) step(i, q0 + i);  // uniform over the warp
}

template <int LMAX, int G>
static int launch(bool drop, const int2* t1, const int2* t2,
                  const int32_t* p1, const int32_t* p2, const int32_t* rinv1,
                  const int32_t* rinv2, const int32_t* sid,
                  const uint8_t* is_start, const int32_t* du,
                  const float* hist_in, const int32_t* rl_in,
                  const int32_t* seg, float* a, int32_t* best_l,
                  int32_t* rl_out, int W, int L, int B, int K, int pad,
                  int bits, uint32_t thr_half, cudaStream_t stream) {
  const int units = K * ((B + 32 / G - 1) / (32 / G));  // warp per (segment, 32/G rows)
  auto kernel =
      best_l != nullptr
          ? (drop ? fused_forward_scan_kernel<LMAX, G, true, true>
                  : fused_forward_scan_kernel<LMAX, G, false, true>)
          : (drop ? fused_forward_scan_kernel<LMAX, G, true, false>
                  : fused_forward_scan_kernel<LMAX, G, false, false>);
  kernel<<<units, 32, 0, stream>>>(t1, t2, p1, p2, rinv1, rinv2, sid,
                                   is_start, du, hist_in, rl_in, seg, a,
                                   best_l, rl_out, W, L, B, K, pad, bits,
                                   thr_half);
  return (int)cudaGetLastError();
}

#define TGX_FUSED_LAUNCH(LM, GG)                                              \
  return launch<LM, GG>(                                                      \
      drop != 0, reinterpret_cast<const int2*>(t1),                           \
      reinterpret_cast<const int2*>(t2), p1, p2, rinv1, rinv2, sid, is_start, \
      du, hist_in, rl_in, seg, a, best_l, rl_out, W, L, B, K, pad, bits,      \
      thr_half, (cudaStream_t)stream)

// The Viterbi kind: dp and best_l out (best_l not null), the final run
// length out, rows cut into K chains at seg (null: K = 1). du may be null
// when drop == 0. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int tgx_fused_forward(
    const int32_t* t1, const int32_t* t2, const int32_t* p1, const int32_t* p2,
    const int32_t* rinv1, const int32_t* rinv2, const int32_t* sid,
    const uint8_t* is_start, const int32_t* du, const float* hist_in,
    const int32_t* rl_in, const int32_t* seg, float* a, int32_t* best_l,
    int32_t* rl_out, int W, int L, int B, int K, int pad, int bits, int drop,
    unsigned int thr_half, void* stream) {
  if (best_l == nullptr) return (int)cudaErrorInvalidValue;
  TGX_SCAN_DISPATCH(L, TGX_FUSED_LAUNCH);
}

// The log-sum-exp kind: the forward values a and the final run length
// out, rows cut into K chains at seg (null: K = 1). du may be null when
// drop == 0. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tgx_fused_forward_lse(
    const int32_t* t1, const int32_t* t2, const int32_t* p1, const int32_t* p2,
    const int32_t* rinv1, const int32_t* rinv2, const int32_t* sid,
    const uint8_t* is_start, const int32_t* du, const float* hist_in,
    const int32_t* rl_in, const int32_t* seg, float* a, int32_t* rl_out,
    int W, int L, int B, int K, int pad, int bits, int drop,
    unsigned int thr_half, void* stream) {
  int32_t* best_l = nullptr;
  TGX_SCAN_DISPATCH(L, TGX_FUSED_LAUNCH);
}

#undef TGX_FUSED_LAUNCH
