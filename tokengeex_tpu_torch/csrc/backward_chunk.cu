// Backward (log-sum-exp) DP over a probed, start-indexed score cache, for
// Hopper (sm_90a): the token marginals and the betas as sample-parallel
// scans over the whole width.
//
// Replaces: tokengeex_tpu/ops/lattice_pallas.py `backward_chunk`
// (kernel `_backward_kernel`), and the XLA scan `_backward_betas_impl` of
// tokengeex_tpu/ops/lattice_jax.py (the betas).
//
// The recurrence, per packed row, walking positions q downwards
// (j = token length - 1, hist[j] = beta at dp index q+1+j):
//   cand[j]    = s[q, j] + hist[j]
//   m = max_j cand[j];  has = m > NEG / 2;  safe = has ? m : 0
//   beta       = has ? safe + logf(sum_j expf(cand[j] - safe)) : NEG
//   hist       <- [end[q] ? 0 : beta, hist[0], ..., hist[L-2]]
// (sum in ascending j). NEG = -3e38; NEG + NEG rounds to -inf, which the
// max and the `has` test absorb. expf/logf are the full-precision library
// functions (no fast math).
//
// Both kernels cut a row into chains at seg[k, r], the first sample END
// or padding byte at or after k*S (seg[0] = 0, seg[K] = n), chain k
// walking [seg[k], seg[k+1]) downwards from the row's hist_in where
// seg[k+1] == n and from [0, NEG, ...] at an inner bound (a token
// crossing it is masked, so the history beyond it adds expf(.) = 0
// exactly, and its own marginal is expf(NEG) = 0 either way). Their
// layout is forward_chunk.cu's: a chain's lengths on a group of G lanes
// (scan_lanes.cuh), 32 / G neighbouring rows of one segment per warp
// walking their chains in lockstep, loads D steps ahead in a register
// ring. Dropout draws each token's coin from du at its start q: a token
// of length l > 1 is dropped iff
// ((du[pad + q] * (l * 2654435761)) >>> 1) < thr >>> 1 (every token of a
// step starts at q, so a step loads one word).
//
// `backward_marginal_scan_kernel` (the per-pass E-step's counts, and the
// chunk API `backward_chunk`) also writes
//   marg[q, j] = expf(max(a[q] + s[q, j] + hist[j] - z[q], NEG))
// from the history before the step, a[q] the forward value of a token
// starting at q (0 at a sample start) and z[q] the normaliser of q's
// sample, added in the twin's order; and the post-reset betas and the
// history when asked. Its step is branch-free, as viterbi_chunk.cu's:
// the chain start is a select, loads past the array read its row 0, only
// the last partial ring of steps is guarded, so the compiler overlaps
// neighbouring steps. The marginals lie (n, B, L) in memory, a row's L
// lengths side by side, so that a warp's store at a step (its 32 / G
// chains' lengths) is one 128-byte line; in the cache's (n, L, B) order
// the same store touched 16 sectors and the group took 3.5x as long
// (experiments/torch_marginal_design.py). Bound: the recurrence (the
// longest chain's steps times one step's latency); its bytes, the cache
// read and the marginals written once, 8 per (position, length), are
// ~0.17 ms for a 8192 x 16 x 512 group at 3.35 TB/s.
//
// `backward_betas_scan_kernel` (the session's betas, and the chunk API
// `backward_betas_chunk`) writes the post-reset betas
//   betas[q] = end[q] ? 0 : beta
// and is the mirror of forward_chunk.cu's scan. Bound: the recurrence;
// its bytes, the cache read once, are ~0.09 ms for a 8192 x 16 x 512
// group.
//
// Float type: the marginal scan is templated on F, float everywhere and
// double for the f64 / exact conformance E-step
// (`tgx_backward_marginal_scan_f64`); the betas scan is f32 only (the f64
// route takes no session betas).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tokengeex_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "scan_lanes.cuh"

template <typename F, int LMAX, int G, bool DROP>
__global__ void __launch_bounds__(32) backward_marginal_scan_kernel(
    const F* __restrict__ score,    // (n, L, B) start-indexed
    const F* __restrict__ a,        // (n, B) forward value at a start
    const F* __restrict__ z,        // (n, B) the sample's normaliser
    const F* __restrict__ reset,    // (n, B) 1.0 where a sample ends at q
    const F* __restrict__ hist_in,  // (L, B) betas after position n
    const int32_t* __restrict__ seg,    // (K+1, B) chain bounds, or null
    const int32_t* __restrict__ du,     // (pad + n + pad, B), DROP only
    F* __restrict__ marg,           // (n, B, L)
    F* __restrict__ betas,          // (n, B), or null
    F* __restrict__ hist_out,       // (L, B), or null (K == 1 only)
    int n, int L, int B, int pad, uint32_t thr_half) {
  constexpr int P = LMAX / G;   // lengths per lane: j = g + G * p
  constexpr int CH = 32 / G;    // chains (rows) per warp
  constexpr int D = TGX_SCAN_D;
  const F NEG = tgx_neg<F>();
  // By step parity (one barrier a step), rows 16-byte aligned (SumRow).
  __shared__ __align__(16) F e_s[2][CH][SumRow<LMAX>::stride];
  const int lane = threadIdx.x;
  const int g = lane % G;
  const int c = lane / G;
  const int groups = (B + CH - 1) / CH;
  const int k = blockIdx.x / groups;
  const int r = (blockIdx.x % groups) * CH + c;
  const bool row = r < B;
  const int rr = row ? r : 0;  // lanes without a row read row 0
  const size_t Bs = (size_t)B;

  // This lane's chain [b0, b1), walked downwards from b1 - 1; the warp
  // walks the union of its chains'.
  int b0 = INT_MAX, b1 = INT_MAX;
  if (row) tgx_chain(seg, k, r, Bs, n, b0, b1);
  const int lo = __reduce_min_sync(TGX_FULL, b0);
  const int hi = __reduce_max_sync(TGX_FULL, row ? b1 : INT_MIN);
  if (lo >= hi) return;

  // The ring, D steps deep: this lane's P scores, the length-1 score, the
  // end flag, a, z and the dropout word of the step's start. Steps below
  // the array read its row 0, so no load is guarded by a branch.
  F rs[D][P], r0[D], rf[D], ra[D], rz[D];
  uint32_t ru[DROP ? D : 1];
  auto fetch = [&](int i, int q) {
    const int qc = max(q, 0);
    const F* sq = score + (size_t)qc * L * Bs + rr;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int j = g + G * p;
      rs[i][p] = (j < L) ? sq[j * Bs] : NEG;
    }
    r0[i] = sq[0];
    const size_t o = (size_t)qc * Bs + rr;
    rf[i] = reset[o];
    ra[i] = a[o];
    rz[i] = z[o];
    if constexpr (DROP) ru[i] = (uint32_t)du[(size_t)(pad + qc) * Bs + rr];
  };

  // The history, as `tgx_lse_step` keeps it, and the one it takes at the
  // chain's first step: the row's (the last chain) or a reset's.
  F h[P], hx[P], hs[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = g + G * p;
    h[p] = hx[p] = NEG;
    hs[p] = (j >= L) ? NEG
          : (b1 == n) ? hist_in[j * Bs + rr]
          : (j == 0 ? F(0) : NEG);
  }
  F h0 = NEG;  // hist[0], on every lane of the group
  const F hs0 = (b1 == n) ? hist_in[rr] : F(0);

  // One step, branch-free, so that the compiler can overlap a step's
  // shuffles and exponentials with its neighbours' across the ring.
  auto step = [&](int i, int q) {
    const bool start = q == b1 - 1;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      h[p] = start ? hs[p] : h[p];
      hx[p] = start ? hs[p] : hx[p];
    }
    h0 = start ? hs0 : h0;
    F sc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      sc[p] = tgx_max(rs[i][p], NEG);
      if constexpr (DROP)
        sc[p] = tgx_dropped(ru[i], g + G * p, thr_half) ? NEG : sc[p];
    }
    // The marginals read the history before the step: h holds every
    // hist[j], lane 0's h[0] included.
    const bool mine = q >= b0 && q < b1;
    F* mq = marg + ((size_t)q * Bs + r) * L;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int j = g + G * p;
      const F m = tgx_exp(tgx_max(ra[i] + sc[p] + h[p] - rz[i], NEG));
      if (mine && j < L) mq[j] = m;
    }
    // Length 1 draws no coin; a + b == b + a, so the step adds as
    // cand[j] = s[j] + hist[j] did.
    const bool end = rf[i] > F(0.5);
    const F lse = tgx_lse_step<LMAX, G>(
        h, hx, h0, sc, tgx_max(r0[i], NEG), end, &e_s[q & 1][c][0], g, L);
    if (betas != nullptr && g == 0 && mine)
      betas[(size_t)q * Bs + r] = end ? F(0) : lse;
    fetch(i, q - D);  // the slot is consumed: refill it
  };

#pragma unroll
  for (int i = 0; i < D; ++i) fetch(i, hi - 1 - i);

  int q0 = hi - 1;
  for (; q0 - (D - 1) >= lo; q0 -= D) {
#pragma unroll
    for (int i = 0; i < D; ++i) step(i, q0 - i);
  }
#pragma unroll
  for (int i = 0; i < D; ++i)
    if (q0 - i >= lo) step(i, q0 - i);  // uniform over the warp

  if (hist_out != nullptr && row) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int j = g + G * p;
      if (j < L) hist_out[j * Bs + r] = h[p];
    }
  }
}

template <int LMAX, int G, bool DROP>
__global__ void __launch_bounds__(32) backward_betas_scan_kernel(
    const float* __restrict__ score,    // (n, L, B) start-indexed
    const float* __restrict__ reset,    // (n, B) 1.0 where a sample ends at q
    const float* __restrict__ hist_in,  // (L, B) betas after position n
    const int32_t* __restrict__ seg,    // (K+1, B) chain bounds, or null
    const int32_t* __restrict__ du,     // (pad + n + pad, B), DROP only
    float* __restrict__ betas,          // (n, B)
    float* __restrict__ hist_out,       // (L, B), or null (K == 1 only)
    int n, int L, int B, int pad, uint32_t thr_half) {
  constexpr int P = LMAX / G;   // lengths per lane: j = g + G * p
  constexpr int CH = 32 / G;    // chains (rows) per warp
  constexpr int D = TGX_SCAN_D;
  // By step parity (one barrier a step), rows 16-byte aligned (SumRow).
  __shared__ __align__(16) float e_s[2][CH][SumRow<LMAX>::stride];
  const int lane = threadIdx.x;
  const int g = lane % G;
  const int c = lane / G;
  const int groups = (B + CH - 1) / CH;
  const int k = blockIdx.x / groups;
  const int r = (blockIdx.x % groups) * CH + c;
  const bool row = r < B;
  const size_t Bs = (size_t)B;

  // This lane's chain [b0, b1), walked downwards from b1 - 1.
  int b0 = INT_MAX, b1 = INT_MAX;
  if (row) tgx_chain(seg, k, r, Bs, n, b0, b1);
  const int lo = __reduce_min_sync(TGX_FULL, b0);
  const int hi = __reduce_max_sync(TGX_FULL, row ? b1 : INT_MIN);
  if (lo >= hi) return;

  // The ring, D steps deep: this lane's P scores, the length-1 score, the
  // end flag and the dropout word of the step's start.
  float rs[D][P], r0[D], rf[D];
  uint32_t ru[DROP ? D : 1];
  auto fetch = [&](int i, int q) {
    if (row && q >= lo) {
      const float* sq = score + (size_t)q * L * Bs + r;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int j = g + G * p;
        rs[i][p] = (j < L) ? sq[j * Bs] : TGX_NEG;
      }
      r0[i] = sq[0];
      rf[i] = reset[(size_t)q * Bs + r];
      if constexpr (DROP) ru[i] = (uint32_t)du[(size_t)(pad + q) * Bs + r];
    }
  };

  // The history, as `tgx_lse_step` keeps it.
  float h[P], hx[P];
#pragma unroll
  for (int p = 0; p < P; ++p) h[p] = hx[p] = TGX_NEG;
  float h0 = TGX_NEG;  // hist[0], on every lane of the group

#pragma unroll
  for (int i = 0; i < D; ++i) fetch(i, hi - 1 - i);

  for (int q0 = hi - 1; q0 >= lo; q0 -= D) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int q = q0 - i;
      if (q < lo) break;  // uniform over the warp
      if (q == b1 - 1) {  // chain start: the row's history, or a reset's
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int j = g + G * p;
          h[p] = (j >= L) ? TGX_NEG
               : (b1 == n) ? hist_in[j * Bs + r]
               : (j == 0 ? 0.0f : TGX_NEG);
          hx[p] = h[p];
        }
        h0 = (b1 == n) ? hist_in[r] : 0.0f;
      }
      float sc[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        sc[p] = fmaxf(rs[i][p], TGX_NEG);
        if constexpr (DROP)
          if (tgx_dropped(ru[i], g + G * p, thr_half)) sc[p] = TGX_NEG;
      }
      // Length 1 draws no coin; a + b == b + a, so the step adds as
      // cand[j] = s[j] + hist[j] did.
      const bool end = rf[i] > 0.5f;
      const float lse = tgx_lse_step<LMAX, G>(
          h, hx, h0, sc, fmaxf(r0[i], TGX_NEG), end, &e_s[q & 1][c][0], g,
          L);
      if (g == 0 && q >= b0 && q < b1)
        betas[(size_t)q * Bs + r] = end ? 0.0f : lse;
      fetch(i, q - D);  // the slot is consumed: refill it
    }
  }

  if (hist_out != nullptr && row) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int j = g + G * p;
      if (j < L) hist_out[j * Bs + r] = h[p];
    }
  }
}

template <typename F, int LMAX, int G>
static int launch_marg(const F* score, const F* a, const F* z,
                       const F* reset, const F* hist_in,
                       const int32_t* seg, const int32_t* du, F* marg,
                       F* betas, F* hist_out, int n, int L, int B,
                       int K, int pad, uint32_t thr_half, bool drop,
                       cudaStream_t stream) {
  const int blocks = K * ((B + 32 / G - 1) / (32 / G));  // warp per (segment, 32/G rows)
  auto kernel = drop ? backward_marginal_scan_kernel<F, LMAX, G, true>
                     : backward_marginal_scan_kernel<F, LMAX, G, false>;
  kernel<<<blocks, 32, 0, stream>>>(score, a, z, reset, hist_in, seg, du,
                                    marg, betas, hist_out, n, L, B, pad,
                                    thr_half);
  return (int)cudaGetLastError();
}

template <int LMAX, int G>
static int launch_betas(const float* score, const float* reset,
                        const float* hist_in, const int32_t* seg,
                        const int32_t* du, float* betas, float* hist_out,
                        int n, int L, int B, int K, int pad,
                        uint32_t thr_half, bool drop, cudaStream_t stream) {
  const int blocks = K * ((B + 32 / G - 1) / (32 / G));  // warp per (segment, 32/G rows)
  if (drop) {
    backward_betas_scan_kernel<LMAX, G, true><<<blocks, 32, 0, stream>>>(
        score, reset, hist_in, seg, du, betas, hist_out, n, L, B, pad,
        thr_half);
  } else {
    backward_betas_scan_kernel<LMAX, G, false><<<blocks, 32, 0, stream>>>(
        score, reset, hist_in, seg, du, betas, hist_out, n, L, B, pad,
        thr_half);
  }
  return (int)cudaGetLastError();
}

extern "C" int tgx_backward_betas_scan(const float* score, const float* reset,
                                       const float* hist_in,
                                       const int32_t* seg, const int32_t* du,
                                       float* betas, float* hist_out, int n,
                                       int L, int B, int K, int pad,
                                       unsigned thr_half, int use_drop,
                                       void* stream) {
#define TGX_LAUNCH(LM, GG)                                                   \
  return launch_betas<LM, GG>(score, reset, hist_in, seg, du, betas,         \
                              hist_out, n, L, B, K, pad, thr_half,           \
                              use_drop != 0, (cudaStream_t)stream)
  TGX_SCAN_DISPATCH(L, TGX_LAUNCH);
#undef TGX_LAUNCH
}

// The whole-width marginal scan: rows cut into K chains at seg (null: K =
// 1), betas and the history out only where their pointers are not null
// (the history with K == 1). du may be null when use_drop == 0. Returns
// cudaGetLastError() after the launch (0 on success).
template <typename F>
static int marginal_scan(const F* score, const F* a, const F* z,
                         const F* reset, const F* hist_in, const int32_t* seg,
                         const int32_t* du, F* marg, F* betas, F* hist_out,
                         int n, int L, int B, int K, int pad,
                         unsigned thr_half, int use_drop, void* stream) {
#define TGX_LAUNCH(LM, GG)                                                   \
  return launch_marg<F, LM, GG>(score, a, z, reset, hist_in, seg, du, marg,  \
                                betas, hist_out, n, L, B, K, pad, thr_half,  \
                                use_drop != 0, (cudaStream_t)stream)
  TGX_SCAN_DISPATCH(L, TGX_LAUNCH);
#undef TGX_LAUNCH
}

extern "C" int tgx_backward_marginal_scan(
    const float* score, const float* a, const float* z, const float* reset,
    const float* hist_in, const int32_t* seg, const int32_t* du, float* marg,
    float* betas, float* hist_out, int n, int L, int B, int K, int pad,
    unsigned thr_half, int use_drop, void* stream) {
  return marginal_scan<float>(score, a, z, reset, hist_in, seg, du, marg,
                              betas, hist_out, n, L, B, K, pad, thr_half,
                              use_drop, stream);
}

// The marginal scan in double (the f64 / exact conformance E-step):
// double exp and log in full precision.
extern "C" int tgx_backward_marginal_scan_f64(
    const double* score, const double* a, const double* z,
    const double* reset, const double* hist_in, const int32_t* seg,
    const int32_t* du, double* marg, double* betas, double* hist_out, int n,
    int L, int B, int K, int pad, unsigned thr_half, int use_drop,
    void* stream) {
  return marginal_scan<double>(score, a, z, reset, hist_in, seg, du, marg,
                               betas, hist_out, n, L, B, K, pad, thr_half,
                               use_drop, stream);
}

extern "C" int tgx_backward_chunk(const float* score, const float* a,
                                  const float* z, const float* ends,
                                  const float* hist_in, float* marg,
                                  float* hist_out, int C, int L, int B,
                                  void* stream) {
  return tgx_backward_marginal_scan(score, a, z, ends, hist_in, nullptr,
                                    nullptr, marg, nullptr, hist_out, C, L,
                                    B, 1, 0, 0u, 0, stream);
}
