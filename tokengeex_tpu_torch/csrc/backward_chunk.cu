// Backward (log-sum-exp) DP over a probed, start-indexed score slab, for
// Hopper (sm_90a): the token marginals of one chunk, and the betas as a
// sample-parallel scan over the whole width.
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
// `backward_chunk_kernel` (marginals, the per-pass route's chunks) also
// writes marg[q, j] = expf(max(a[q] + s[q, j] + hist[j] - z[q], NEG)),
// a[q] the forward value of a token starting at q (0 at a sample start)
// and z[q] the normaliser of q's sample. It is bound by bytes (slab in,
// marginals out, 8 bytes per (position, length)); one thread per row,
// the history in registers, (C, L, B) so every warp access is one
// 128-byte transaction.
//
// `backward_betas_scan_kernel` (the session's betas, and the chunk API
// `backward_betas_chunk`) writes the post-reset betas
//   betas[q] = end[q] ? 0 : beta
// and is the mirror of forward_chunk.cu's scan: chains cut at seg[k, r],
// the first sample END or padding byte at or after k*S (seg[0] = 0,
// seg[K] = n), chain k walking [seg[k], seg[k+1]) downwards from the
// row's hist_in where seg[k+1] == n and from [0, NEG, ...] at an inner
// bound (a token crossing it is masked, so the history beyond it adds
// expf(.) = 0 exactly). Its layout is forward_chunk.cu's: a chain's
// lengths on a group of G lanes (scan_lanes.cuh), 32 / G neighbouring
// rows of one segment per warp walking their chains in lockstep, loads D
// steps ahead in a register ring. Dropout draws each token's coin from du
// at its start q: a token of length l > 1 is dropped iff
// ((du[pad + q] * (l * 2654435761)) >>> 1) < thr >>> 1. Bound: the
// recurrence (the longest chain's steps times one step's latency); its
// bytes, the slab read once, are ~0.09 ms for a 8192 x 16 x 512 group.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tokengeex_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "scan_lanes.cuh"

template <int LMAX>
__global__ void backward_chunk_kernel(const float* __restrict__ score,    // (C, L, B)
                                      const float* __restrict__ a,        // (C, B)
                                      const float* __restrict__ z,        // (C, B)
                                      const float* __restrict__ ends,     // (C, B)
                                      const float* __restrict__ hist_in,  // (L, B)
                                      float* __restrict__ marg,           // (C, L, B)
                                      float* __restrict__ hist_out,       // (L, B)
                                      int C, int L, int B) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  const size_t Bs = (size_t)B;

  float h[LMAX];
#pragma unroll
  for (int j = 0; j < LMAX; ++j) h[j] = (j < L) ? hist_in[j * Bs + r] : TGX_NEG;

  for (int q = C - 1; q >= 0; --q) {
    const size_t row = (size_t)q * L * Bs + r;
    const float aq = a[q * Bs + r];
    const float zq = z[q * Bs + r];
    float cand[LMAX];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < LMAX; ++j) {
      if (j < L) {
        const float s = score[row + j * Bs];
        marg[row + j * Bs] = expf(fmaxf(aq + s + h[j] - zq, TGX_NEG));
        cand[j] = s + h[j];
        m = fmaxf(m, cand[j]);
      }
    }
    const bool has = m > TGX_NEG * 0.5f;
    const float safe = has ? m : 0.0f;
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < LMAX; ++j) {
      if (j < L) t += expf(cand[j] - safe);
    }
    const float lse = has ? safe + logf(t) : TGX_NEG;
    const float carry = (ends[q * Bs + r] > 0.5f) ? 0.0f : lse;
#pragma unroll
    for (int j = LMAX - 1; j > 0; --j) h[j] = h[j - 1];
    h[0] = carry;
  }

#pragma unroll
  for (int j = 0; j < LMAX; ++j)
    if (j < L) hist_out[j * Bs + r] = h[j];
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

template <int LMAX>
static void launch_marg(const float* score, const float* a, const float* z,
                        const float* ends, const float* hist_in, float* marg,
                        float* hist_out, int C, int L, int B,
                        cudaStream_t stream) {
  const int threads = 32;  // one warp per block: rows spread over SMs
  const int blocks = (B + threads - 1) / threads;
  backward_chunk_kernel<LMAX><<<blocks, threads, 0, stream>>>(
      score, a, z, ends, hist_in, marg, hist_out, C, L, B);
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

// Each returns cudaGetLastError() after the launch (0 on success).
extern "C" int tgx_backward_chunk(const float* score, const float* a,
                                  const float* z, const float* ends,
                                  const float* hist_in, float* marg,
                                  float* hist_out, int C, int L, int B,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (L <= 8) {
    launch_marg<8>(score, a, z, ends, hist_in, marg, hist_out, C, L, B, s);
  } else if (L <= 16) {
    launch_marg<16>(score, a, z, ends, hist_in, marg, hist_out, C, L, B, s);
  } else if (L <= 32) {
    launch_marg<32>(score, a, z, ends, hist_in, marg, hist_out, C, L, B, s);
  } else if (L <= 64) {
    launch_marg<64>(score, a, z, ends, hist_in, marg, hist_out, C, L, B, s);
  } else {
    return (int)cudaErrorInvalidValue;
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
