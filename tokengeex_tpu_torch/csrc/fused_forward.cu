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
//   then the Viterbi relaxation of viterbi_chunk.cu (dp and best_l out),
//   or the log-sum-exp step of forward_chunk.cu (m = max cand, has = m >
//   NEG/2, a = has ? m + logf(sum expf(cand - m)) : NEG, the forward
//   values a out, the sum in ascending j). Either carries 0 at a sample
//   start. rl = inb ? (start ? 1 : rl + 1) : 0 is the run length.
//
// Two kernels:
//
// `fused_viterbi_kernel` (encode): one thread per packed row walks all W
// positions, the DP history in registers; a step's lengths go in tiles of
// 8 whose loads carry no row-dependent branch, so they overlap. Bound by
// its dependent loads (PERF.md); its redesign is ROADMAP's next item.
//
// `fused_lse_scan_kernel` (the session's E-step), a chained, lane-parallel
// scan:
//   - Chains. A row is cut at seg[k, r] (ops/lattice.py `chain_bounds`:
//     the first sample start or padding byte at or after k * S): every
//     token reaching back across such a byte is invalid (l > rl), so the
//     history older than the bound meets only NEG scores and adds
//     expf(.) = 0 exactly, and rl restarts there from its own byte. Chain
//     0 starts from hist_in / rl_in, every other from [0, NEG, ...] with rl
//     rebuilt at its first byte. seg == null is one chain per row.
//   - Lanes. A chain's L lengths sit on a group of G lanes (scan_lanes.cuh,
//     one length per lane at L <= 16 with G = 16), 32 / G rows of one
//     segment per warp walking their chains in lockstep. Each lane forms
//     its own token's fingerprint, slots and coin; the max goes by shuffles
//     and the sum in ascending j through shared memory, as the twins add.
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
//     expf / sum / logf and the history shift remain; the score select and
//     the length-1 score's broadcast are off that path.
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

template <int LMAX, bool DROP>
__global__ void fused_viterbi_kernel(
    const int2* __restrict__ t1,         // (H,) rows [check = fp2, f32 score bits]
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
    float* __restrict__ dp,              // (W, B)
    int32_t* __restrict__ best_l,        // (W, B)
    float* __restrict__ hist_out,        // (L, B)
    int32_t* __restrict__ rl_out,        // (B,)
    int W, int L, int B, int pad, int bits, uint32_t thr_half) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  const size_t Bs = (size_t)B;
  const int shift = 32 - bits;

  float h[LMAX];
#pragma unroll
  for (int j = 0; j < LMAX; ++j) h[j] = (j < L) ? hist_in[j * Bs + r] : TGX_NEG;
  int rl = rl_in[r];

  for (int q = 0; q < W; ++q) {
    const bool inb = sid[(size_t)(pad + q) * Bs + r] >= 0;
    const bool stb = is_start[(size_t)q * Bs + r] != 0;
    rl = inb ? (stb ? 1 : rl + 1) : 0;
    const uint32_t e1 = (uint32_t)p1[(size_t)(pad + q + 1) * Bs + r];
    const uint32_t e2 = (uint32_t)p2[(size_t)(pad + q + 1) * Bs + r];

    float s[LMAX];
    float cand[LMAX];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < LMAX; t += 8) {
      if (t >= L) break;  // uniform: every thread has the same L
      // Issue all loads of a tile of 8 lengths before any select: no
      // branch depends on the row, so the 8 start hashes, then the 16
      // table rows, are in flight together. Lengths past the sample
      // run are probed too and dropped by `ok` below.
      uint32_t fp2v[8];
      int2 r1v[8];
      int2 r2v[8];
      uint32_t duv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t l = (uint32_t)(t + k + 1);
        const int sp_i = pad + q - (t + k);
        const size_t sp = (size_t)(sp_i > 0 ? sp_i : 0);
        const uint32_t fp1 = (e1 - (uint32_t)p1[sp * Bs + r]) * (uint32_t)rinv1[sp];
        const uint32_t fp2 = (e2 - (uint32_t)p2[sp * Bs + r]) * (uint32_t)rinv2[sp];
        fp2v[k] = fp2;
        r1v[k] = t1[tgx_slot1(fp1, l, shift)];
        r2v[k] = t2[tgx_slot2(fp2, l, shift)];
        if (DROP) duv[k] = (uint32_t)du[sp * Bs + r];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = t + k;
        bool ok = j < L && j + 1 <= rl;
        if (DROP && tgx_dropped(duv[k], j, thr_half)) ok = false;
        const float sc = tgx_probe_score(r1v[k], r2v[k], fp2v[k], ok);
        s[j] = sc;
        cand[j] = (j < L) ? h[j] + sc : -INFINITY;
        m = fmaxf(m, cand[j]);
      }
    }
    int jbest = -1;
#pragma unroll
    for (int j = 0; j < LMAX; ++j) {
      if (j < L && cand[j] >= m && s[j] > TGX_NEG) jbest = j;
    }
    const float v = (jbest >= 0) ? m : TGX_NEG;
    best_l[q * Bs + r] = (jbest >= 0) ? jbest + 1 : 1;
    dp[q * Bs + r] = v;
    const float carry = (is_start[(size_t)(q + 1) * Bs + r] != 0) ? 0.0f : v;
#pragma unroll
    for (int j = LMAX - 1; j > 0; --j) h[j] = h[j - 1];
    h[0] = carry;
  }

#pragma unroll
  for (int j = 0; j < LMAX; ++j)
    if (j < L) hist_out[j * Bs + r] = h[j];
  rl_out[r] = rl;
}

template <int LMAX, int G, bool DROP>
__global__ void __launch_bounds__(32) fused_lse_scan_kernel(
    const int2* __restrict__ t1,         // (H,) rows [check = fp2, f32 score bits]
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
    float* __restrict__ a,               // (W, B) forward values
    int32_t* __restrict__ rl_out,        // (B,) run length after byte W - 1
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

  // This lane's chain [b0, b1); the warp walks the union of its chains'.
  int b0 = INT_MAX, b1 = INT_MAX;
  if (row) tgx_chain(seg, k, r, Bs, W, b0, b1);
  const int lo = __reduce_min_sync(TGX_FULL, b0);
  const int hi = __reduce_max_sync(TGX_FULL, row ? b1 : INT_MIN);
  if (lo >= hi) return;

  // Stream ring: the words of step t, loaded 2D steps ahead.
  uint32_t se1[D], se2[D], sr1[D], sr2[D], sdu[DROP ? D : 1];
  int32_t ssid[D];
  uint8_t sst[D], snx[D];
  auto fetch = [&](int i, int t) {
    if (t < hi) {
      const size_t pt = (size_t)(pad + t);
      se1[i] = (uint32_t)p1[(pt + 1) * Bs + rr];
      se2[i] = (uint32_t)p2[(pt + 1) * Bs + rr];
      sr1[i] = (uint32_t)rinv1[pt];
      sr2[i] = (uint32_t)rinv2[pt];
      if constexpr (DROP) sdu[i] = (uint32_t)du[pt * Bs + rr];
      ssid[i] = sid[pt * Bs + rr];
      sst[i] = is_start[(size_t)t * Bs + rr];
      snx[i] = is_start[(size_t)(t + 1) * Bs + rr];
    }
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

  // Probe ring: step t's gathered rows, fp2, validity bits and reset flag.
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
      gf[i][p] = fp2;
      bool v = j < L && (int)l <= rl;
      if constexpr (DROP) v = v && !tgx_dropped(dh[p], j, thr_half);
      ok |= (uint32_t)v << p;
    }
    gok[i] = ok;
    grs[i] = snx[i] != 0;
  };

  // The history, as `tgx_lse_step` keeps it.
  float h[P], hx[P];
#pragma unroll
  for (int p = 0; p < P; ++p) h[p] = hx[p] = TGX_NEG;
  float h0 = TGX_NEG;  // hist[0], on every lane of the group

#pragma unroll
  for (int i = 0; i < D; ++i) fetch(i, lo + i);
#pragma unroll
  for (int i = 0; i < D; ++i) probe(i, lo + i);
#pragma unroll
  for (int i = 0; i < D; ++i) fetch(i, lo + D + i);

  for (int q0 = lo; q0 < hi; q0 += D) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int q = q0 + i;
      if (q >= hi) break;  // uniform over the warp
      if (q == b0) {  // chain start: the row's history, or a reset's
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int j = g + G * p;
          h[p] = (j >= L) ? TGX_NEG
               : (b0 == 0) ? hist_in[j * Bs + r]
               : (j == 0 ? 0.0f : TGX_NEG);
          hx[p] = h[p];
        }
        h0 = (b0 == 0) ? hist_in[r] : 0.0f;
      }
      float sc[P];
#pragma unroll
      for (int p = 0; p < P; ++p)
        sc[p] = tgx_probe_score(g1[i][p], g2[i][p], gf[i][p],
                                (gok[i] >> p) & 1u);
      // The length-1 score, from the group's lane 0, on every lane.
      const float s0 = (G == 1) ? sc[0] : __shfl_sync(TGX_FULL, sc[0], 0, G);
      const float lse = tgx_lse_step<LMAX, G>(
          h, hx, h0, sc, s0, grs[i], &e_s[q & 1][c][0], g, L);
      if (g == 0 && q >= b0 && q < b1) a[(size_t)q * Bs + r] = lse;
      probe(i, q + D);  // the slot is consumed: refill both rings
      fetch(i, q + 2 * D);
    }
  }
}

template <int LMAX>
static void launch_viterbi(bool drop, const int2* t1, const int2* t2,
                           const int32_t* p1, const int32_t* p2,
                           const int32_t* rinv1, const int32_t* rinv2,
                           const int32_t* sid, const uint8_t* is_start,
                           const int32_t* du, const float* hist_in,
                           const int32_t* rl_in, float* dp, int32_t* best_l,
                           float* hist_out, int32_t* rl_out, int W, int L,
                           int B, int pad, int bits, uint32_t thr_half,
                           cudaStream_t stream) {
  const int threads = 32;  // one warp per block: rows spread over SMs
  const int blocks = (B + threads - 1) / threads;
  if (drop) {
    fused_viterbi_kernel<LMAX, true><<<blocks, threads, 0, stream>>>(
        t1, t2, p1, p2, rinv1, rinv2, sid, is_start, du, hist_in, rl_in, dp,
        best_l, hist_out, rl_out, W, L, B, pad, bits, thr_half);
  } else {
    fused_viterbi_kernel<LMAX, false><<<blocks, threads, 0, stream>>>(
        t1, t2, p1, p2, rinv1, rinv2, sid, is_start, du, hist_in, rl_in, dp,
        best_l, hist_out, rl_out, W, L, B, pad, bits, thr_half);
  }
}

template <int LMAX, int G>
static int launch_lse(bool drop, const int2* t1, const int2* t2,
                      const int32_t* p1, const int32_t* p2,
                      const int32_t* rinv1, const int32_t* rinv2,
                      const int32_t* sid, const uint8_t* is_start,
                      const int32_t* du, const float* hist_in,
                      const int32_t* rl_in, const int32_t* seg, float* a,
                      int32_t* rl_out, int W, int L, int B, int K, int pad,
                      int bits, uint32_t thr_half, cudaStream_t stream) {
  const int units = K * ((B + 32 / G - 1) / (32 / G));  // warp per (segment, 32/G rows)
  auto kernel = drop ? fused_lse_scan_kernel<LMAX, G, true>
                     : fused_lse_scan_kernel<LMAX, G, false>;
  kernel<<<units, 32, 0, stream>>>(t1, t2, p1, p2, rinv1, rinv2, sid,
                                   is_start, du, hist_in, rl_in, seg, a,
                                   rl_out, W, L, B, K, pad, bits, thr_half);
  return (int)cudaGetLastError();
}

// The Viterbi kind: dp and best_l out, hist and rl carried. du may be null
// when drop == 0. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int tgx_fused_forward(
    const int32_t* t1, const int32_t* t2, const int32_t* p1, const int32_t* p2,
    const int32_t* rinv1, const int32_t* rinv2, const int32_t* sid,
    const uint8_t* is_start, const int32_t* du, const float* hist_in,
    const int32_t* rl_in, float* dp, int32_t* best_l, float* hist_out,
    int32_t* rl_out, int W, int L, int B, int pad, int bits, int drop,
    unsigned int thr_half, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int2* a = reinterpret_cast<const int2*>(t1);
  const int2* b = reinterpret_cast<const int2*>(t2);
  const bool d = drop != 0;
  if (L <= 8) {
    launch_viterbi<8>(d, a, b, p1, p2, rinv1, rinv2, sid, is_start, du,
                      hist_in, rl_in, dp, best_l, hist_out, rl_out, W, L, B,
                      pad, bits, thr_half, s);
  } else if (L <= 16) {
    launch_viterbi<16>(d, a, b, p1, p2, rinv1, rinv2, sid, is_start, du,
                       hist_in, rl_in, dp, best_l, hist_out, rl_out, W, L, B,
                       pad, bits, thr_half, s);
  } else if (L <= 32) {
    launch_viterbi<32>(d, a, b, p1, p2, rinv1, rinv2, sid, is_start, du,
                       hist_in, rl_in, dp, best_l, hist_out, rl_out, W, L, B,
                       pad, bits, thr_half, s);
  } else if (L <= 64) {
    launch_viterbi<64>(d, a, b, p1, p2, rinv1, rinv2, sid, is_start, du,
                       hist_in, rl_in, dp, best_l, hist_out, rl_out, W, L, B,
                       pad, bits, thr_half, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
  const int2* x = reinterpret_cast<const int2*>(t1);
  const int2* y = reinterpret_cast<const int2*>(t2);
#define TGX_LAUNCH(LM, GG)                                                    \
  return launch_lse<LM, GG>(drop != 0, x, y, p1, p2, rinv1, rinv2, \
                            sid, is_start, du, hist_in, rl_in, seg, a,        \
                            rl_out, W, L, B, K, pad, bits, thr_half,          \
                            (cudaStream_t)stream)
  TGX_SCAN_DISPATCH(L, TGX_LAUNCH);
#undef TGX_LAUNCH
}
