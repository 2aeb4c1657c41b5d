// Viterbi (max-plus) DP as a sample-parallel scan, for Hopper (sm_90a).
//
// Replaces: tokengeex_tpu/ops/lattice_pallas.py `viterbi_chunk`
// (kernel `_viterbi_kernel`).
//
// What it computes, per packed row and dp step q (j = token length - 1,
// s[q, j] = the score of the token of length j+1 ENDING at dp index q+1):
//   cand[j] = hist[j] + s[q, j];  m = max_j cand[j]
//   best_l  = 1 + the LARGEST j with cand[j] >= m and s[q, j] > NEG
//             (ties go to the longest token); if there is none, best_l = 1
//             and dp = NEG
//   dp[q]   = m
//   hist   <- [reset[q] ? 0 : dp[q], hist[0], ..., hist[L-2]]
// reset[q] is 1.0 where dp index q+1 starts a sample. Scores are clamped
// to NEG = -3e38 here (fmaxf), so the -inf of a miss never meets an add.
//
// Two views of the scores, one body:
//   - whole width (encode's slab route, the session's cached frequency
//     pass): s[q, j] = cache[lead + q - j, j, r] read straight from a
//     START-indexed (lead + n, L, B) score cache, NEG where lead + q - j <
//     0. The first `lead` rows hold the tokens starting before position 0:
//     a chained window's carried tail (ops/lattice.py
//     `prepare_chained_batch`), 0 rows otherwise;
//   - chunk (`viterbi_chunk`): an END-indexed (C, L, B) slab, one chain per
//     row, the history out.
// Dropout (whole width only) draws each token's coin here from the
// dropout words du, keyed on the token's start s = q - j: a token of
// length l > 1 is dropped iff ((du[pad + s] * (l * 2654435761)) >>> 1) <
// thr >>> 1 (uint32 arithmetic), the coin of lattice.py `_match_slab`.
// The words roll down a chain's lanes (`tgx_roll`): a step loads one.
//
// Chains, as in forward_chunk.cu: a row is cut at seg[k, r], the first
// sample start or padding byte at or after k * S; chain 0 starts from
// hist_in, every other from [0, NEG, ...]. The probe masks every token
// that crosses such a byte. In max-plus a masked candidate is hist + NEG
// <= NEG with the row's true history (log-probabilities: scores and
// history <= 0) and NEG + NEG = -inf with the fresh one, so neither
// exceeds a valid candidate (>= NEG while scores stay above about -1e31),
// and the s > NEG test keeps both out of best_l: the chained DP is the
// one-chain-per-row DP bit for bit.
//
// What bounds it on the H100: the recurrence. Bytes are ~4 per (position,
// length) read once (0.08 ms for a 8192 x 16 x 512 group at 3.35 TB/s),
// but step q needs step q-1's value, so the floor is the longest chain's
// steps times one step's latency. Encode packs whole samples of up to 8
// KB into a row, so its longest chain is about the longest sample.
//
// What the design does about it: forward_chunk.cu's layout (chains in
// parallel, one chain's lengths on a group of G lanes, 32 / G rows of one
// segment per warp in lockstep, loads D steps ahead in a register ring)
// with the max-plus step `tgx_max_step` (scan_lanes.cuh): the max over
// lengths >= 2 and the longest length holding it run a step ahead of the
// recurrence, so between two steps only the length-1 candidate and a few
// selects remain, and no shuffle. The step has no branch (the chain start
// is a select, loads past the array read its last row, the last partial
// ring of steps is the only guarded one), so the compiler overlaps the
// shuffles of neighbouring steps across the unrolled ring: 2.7x faster
// than the same step with a branch per step (PERF.md). 16 lanes per chain
// at L <= 16 were timed against 1, 2, 4 and 8
// (experiments/torch_viterbi_design.py).
//
// Float type: the kernel is templated on F, float everywhere and double
// for the f64 / exact conformance route (`tgx_viterbi_scan_f64`, the
// f64 encode and frequency pass): the same adds and compares, the
// sentinel's value in double, ties to the longest token.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tokengeex_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "scan_lanes.cuh"

template <typename F, int LMAX, int G, bool DROP>
__global__ void __launch_bounds__(32) viterbi_scan_kernel(
    const F* __restrict__ score,    // (lead + n, L, B) cache or (n, L, B) slab
    const F* __restrict__ reset,    // (n, B) 1.0 where dp index q+1 starts
    const F* __restrict__ hist_in,  // (L, B)
    const int32_t* __restrict__ seg,    // (K+1, B) chain starts, or null
    const int32_t* __restrict__ du,     // (pad + n + pad, B), DROP only
    F* __restrict__ dp,             // (n, B)
    int32_t* __restrict__ best_l,       // (n, B)
    F* __restrict__ hist_out,       // (L, B), or null (K == 1 only)
    int n, int L, int B, int start_indexed, int lead, int pad,
    uint32_t thr_half) {
  constexpr int P = LMAX / G;   // lengths per lane: j = g + G * p
  constexpr int CH = 32 / G;    // chains (rows) per warp
  constexpr int D = TGX_SCAN_D;
  const F NEG = tgx_neg<F>();
  const int lane = threadIdx.x;
  const int g = lane % G;
  const int c = lane / G;
  const int groups = (B + CH - 1) / CH;
  const int k = blockIdx.x / groups;
  const int r = (blockIdx.x % groups) * CH + c;
  const bool row = r < B;
  const int rr = row ? r : 0;  // lanes without a row read row 0's words
  const size_t Bs = (size_t)B;

  // This lane's chain [b0, b1); the warp walks the union of its chains'.
  int b0 = INT_MAX, b1 = INT_MAX;
  if (row) tgx_chain(seg, k, r, Bs, n, b0, b1);
  const int lo = __reduce_min_sync(TGX_FULL, b0);
  const int hi = __reduce_max_sync(TGX_FULL, row ? b1 : INT_MIN);
  if (lo >= hi) return;

  // s[q, j] lives at q * qs + j * js + r from `base`; a start-indexed
  // cache holds no token starting before -lead (q - j < jlo).
  const long long qs = (long long)L * B;
  const long long js = start_indexed ? (long long)B - qs : (long long)B;
  const int jlo = start_indexed ? -lead : -LMAX;
  const F* base = score + (start_indexed ? (long long)lead * qs : 0);

  // The ring, D steps deep: this lane's P scores, the length-1 score, the
  // reset flag, and the dropout word of the token starting at q. Steps
  // past the array read its last one, so no load is guarded by a branch.
  F rs[D][P], r0[D], rf[D];
  uint32_t ru[DROP ? D : 1];
  auto fetch = [&](int i, int q) {
    const int qc = min(q, n - 1);
    const F* sq = base + (long long)qc * qs + rr;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int j = g + G * p;
      rs[i][p] = (j < L && qc - j >= jlo) ? sq[j * js] : NEG;
    }
    r0[i] = sq[0];
    rf[i] = reset[(size_t)qc * Bs + rr];
    if constexpr (DROP) ru[i] = (uint32_t)du[(size_t)(pad + qc) * Bs + rr];
  };

  // The dropout words of the lane's tokens, one step behind the next step
  // q: lane j holds du[pad + q - 1 - j]. Each step rolls them one length
  // on (`tgx_roll`) with the word of the token starting at q, so a step
  // loads one word, not one per length.
  uint32_t dh[DROP ? P : 1];
  if constexpr (DROP) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i0 = pad + lo - 1 - (g + G * p);
      dh[p] = i0 >= 0 ? (uint32_t)du[(size_t)i0 * Bs + rr] : 0u;
    }
  }

  // The history, as `tgx_max_step` keeps it, and the one it takes at the
  // chain's first step: the row's (chain 0) or a reset's.
  F h[P], hx[P], hs[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = g + G * p;
    h[p] = hx[p] = NEG;
    hs[p] = (j >= L) ? NEG
          : (b0 == 0) ? hist_in[j * Bs + rr]
          : (j == 0 ? F(0) : NEG);
  }
  F h0 = NEG;  // hist[0], on every lane of the group
  const F hs0 = (b0 == 0) ? hist_in[rr] : F(0);

  // One step, branch-free, so that the compiler can overlap a step's
  // shuffles with its neighbours' across the unrolled ring.
  auto step = [&](int i, int q) {
    const bool start = q == b0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      h[p] = start ? hs[p] : h[p];
      hx[p] = start ? hs[p] : hx[p];
    }
    h0 = start ? hs0 : h0;
    if constexpr (DROP) tgx_roll<LMAX, G>(dh, ru[i], g);
    F sc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      sc[p] = tgx_max(rs[i][p], NEG);
      if constexpr (DROP)
        sc[p] = tgx_dropped(dh[p], g + G * p, thr_half) ? NEG : sc[p];
    }
    // Length 1 draws no coin.
    int bl;
    const F v = tgx_max_step<LMAX, G>(
        h, hx, h0, sc, tgx_max(r0[i], NEG), rf[i] > F(0.5), g, L, bl);
    if (g == 0 && q >= b0 && q < b1) {
      dp[(size_t)q * Bs + r] = v;
      best_l[(size_t)q * Bs + r] = bl;
    }
    fetch(i, q + D);  // the slot is consumed: refill it
  };

#pragma unroll
  for (int i = 0; i < D; ++i) fetch(i, lo + i);

  int q0 = lo;
  for (; q0 + D <= hi; q0 += D) {
#pragma unroll
    for (int i = 0; i < D; ++i) step(i, q0 + i);
  }
#pragma unroll
  for (int i = 0; i < D; ++i)
    if (q0 + i < hi) step(i, q0 + i);  // uniform over the warp

  if (hist_out != nullptr && row) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int j = g + G * p;
      if (j < L) hist_out[j * Bs + r] = h[p];
    }
  }
}

template <typename F, int LMAX, int G>
static int launch(const F* score, const F* reset, const F* hist_in,
                  const int32_t* seg, const int32_t* du, F* dp,
                  int32_t* best_l, F* hist_out, int n, int L, int B, int K,
                  int start_indexed, int lead, int pad, uint32_t thr_half,
                  bool drop, cudaStream_t stream) {
  const int blocks = K * ((B + 32 / G - 1) / (32 / G));  // warp per (segment, 32/G rows)
  auto kernel = drop ? viterbi_scan_kernel<F, LMAX, G, true>
                     : viterbi_scan_kernel<F, LMAX, G, false>;
  kernel<<<blocks, 32, 0, stream>>>(score, reset, hist_in, seg, du, dp, best_l,
                                    hist_out, n, L, B, start_indexed, lead,
                                    pad, thr_half);
  return (int)cudaGetLastError();
}

template <typename F>
static int scan(const F* score, const F* reset, const F* hist_in,
                const int32_t* seg, const int32_t* du, F* dp, int32_t* best_l,
                F* hist_out, int n, int L, int B, int K, int start_indexed,
                int lead, int pad, unsigned thr_half, int use_drop,
                void* stream) {
#define TGX_LAUNCH(LM, GG)                                                   \
  return launch<F, LM, GG>(score, reset, hist_in, seg, du, dp, best_l,       \
                           hist_out, n, L, B, K, start_indexed, lead, pad,   \
                           thr_half, use_drop != 0, (cudaStream_t)stream)
  TGX_SCAN_DISPATCH(L, TGX_LAUNCH);
#undef TGX_LAUNCH
}

// The whole-width scan: rows cut into K chains at seg (null: K = 1), the
// history out only when hist_out is not null. du may be null when
// use_drop == 0. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int tgx_viterbi_scan(const float* score, const float* reset,
                                const float* hist_in, const int32_t* seg,
                                const int32_t* du, float* dp, int32_t* best_l,
                                float* hist_out, int n, int L, int B, int K,
                                int start_indexed, int lead, int pad,
                                unsigned thr_half, int use_drop,
                                void* stream) {
  return scan<float>(score, reset, hist_in, seg, du, dp, best_l, hist_out, n,
                     L, B, K, start_indexed, lead, pad, thr_half, use_drop,
                     stream);
}

// The same scan in double (the f64 / exact conformance route): every
// float stream is double, the max-plus step the same adds and compares.
extern "C" int tgx_viterbi_scan_f64(const double* score, const double* reset,
                                    const double* hist_in, const int32_t* seg,
                                    const int32_t* du, double* dp,
                                    int32_t* best_l, double* hist_out, int n,
                                    int L, int B, int K, int start_indexed,
                                    int lead, int pad, unsigned thr_half,
                                    int use_drop, void* stream) {
  return scan<double>(score, reset, hist_in, seg, du, dp, best_l, hist_out, n,
                      L, B, K, start_indexed, lead, pad, thr_half, use_drop,
                      stream);
}

// The chunk API: one END-indexed (C, L, B) slab, one chain per row, the
// history out. Returns cudaGetLastError() after the launch.
extern "C" int tgx_viterbi_chunk(const float* score, const float* starts,
                                 const float* hist_in, float* dp,
                                 int32_t* best_l, float* hist_out, int C,
                                 int L, int B, void* stream) {
  return tgx_viterbi_scan(score, starts, hist_in, nullptr, nullptr, dp, best_l,
                          hist_out, C, L, B, 1, 0, 0, 0, 0u, 0, stream);
}
