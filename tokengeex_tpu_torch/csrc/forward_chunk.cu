// Forward (log-sum-exp) DP over a probed, end-indexed score slab, for
// Hopper (sm_90a).
//
// Replaces: tokengeex_tpu/ops/lattice_pallas.py `forward_chunk`
// (kernel `_forward_kernel`).
//
// What it computes, per packed row and dp step q of the chunk:
//   cand[j] = hist[j] + score[q, j]           (j = token length - 1)
//   m       = max_j cand[j];  has = m > NEG / 2;  safe = has ? m : 0
//   t       = sum_j expf(cand[j] - safe)      (j ascending)
//   a[q]    = has ? safe + logf(t) : NEG
//   hist    <- [start[q] ? 0 : a[q], hist[0], ..., hist[L-2]]
// NEG = -3e38 stands for "no path". NEG + NEG rounds to -inf in f32, which
// the max and the `has` test absorb: expf(-inf) = 0 and no NaN can form.
// expf/logf are the full-precision library functions (no fast math): the
// alphas feed marginals exp(a + s + b - z) whose exponent is a difference
// of values in the thousands.
//
// What bounds it on the H100: bytes. Every score of the (C, L, B) slab is
// read once and takes an add, a max, a subtraction and one expf, so about
// 5 operations per 4 bytes read, under the card's f32 rate per byte.
//
// What the design does about it: one thread per packed row, as in
// viterbi_chunk.cu. The L-deep history lives in registers and the loop over
// the C positions runs inside the thread (the TPU kernel's sequential
// grid). The slab is laid out (C, L, B): neighbouring threads read
// neighbouring rows, so each warp's load of one (position, length) is one
// 128-byte transaction and every slab byte crosses the memory bus once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tokengeex_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TGX_NEG (-3.0e38f)

template <int LMAX>
__global__ void forward_chunk_kernel(const float* __restrict__ score,    // (C, L, B)
                                     const float* __restrict__ starts,   // (C, B)
                                     const float* __restrict__ hist_in,  // (L, B)
                                     float* __restrict__ a,              // (C, B)
                                     float* __restrict__ hist_out,       // (L, B)
                                     int C, int L, int B) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  const size_t Bs = (size_t)B;

  float h[LMAX];
#pragma unroll
  for (int j = 0; j < LMAX; ++j) h[j] = (j < L) ? hist_in[j * Bs + r] : TGX_NEG;

  for (int q = 0; q < C; ++q) {
    const float* sq = score + (size_t)q * L * Bs + r;
    float cand[LMAX];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < LMAX; ++j) {
      if (j < L) {
        cand[j] = h[j] + sq[j * Bs];
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
    a[q * Bs + r] = lse;
    const float carry = (starts[q * Bs + r] > 0.5f) ? 0.0f : lse;
#pragma unroll
    for (int j = LMAX - 1; j > 0; --j) h[j] = h[j - 1];
    h[0] = carry;
  }

#pragma unroll
  for (int j = 0; j < LMAX; ++j)
    if (j < L) hist_out[j * Bs + r] = h[j];
}

template <int LMAX>
static void launch(const float* score, const float* starts, const float* hist_in,
                   float* a, float* hist_out, int C, int L, int B,
                   cudaStream_t stream) {
  const int threads = 32;  // one warp per block: rows spread over SMs
  const int blocks = (B + threads - 1) / threads;
  forward_chunk_kernel<LMAX><<<blocks, threads, 0, stream>>>(
      score, starts, hist_in, a, hist_out, C, L, B);
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tgx_forward_chunk(const float* score, const float* starts,
                                 const float* hist_in, float* a, float* hist_out,
                                 int C, int L, int B, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (L <= 8) {
    launch<8>(score, starts, hist_in, a, hist_out, C, L, B, s);
  } else if (L <= 16) {
    launch<16>(score, starts, hist_in, a, hist_out, C, L, B, s);
  } else if (L <= 32) {
    launch<32>(score, starts, hist_in, a, hist_out, C, L, B, s);
  } else if (L <= 64) {
    launch<64>(score, starts, hist_in, a, hist_out, C, L, B, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
