// Viterbi DP over a probed, end-indexed score slab, for Hopper (sm_90a).
//
// Replaces: tokengeex_tpu/ops/lattice_pallas.py `viterbi_chunk`
// (kernel `_viterbi_kernel`).
//
// What it computes, per packed row and dp step q of the chunk:
//   cand[j] = hist[j] + score[q, j]           (j = token length - 1)
//   m       = max_j cand[j]
//   best_l  = 1 + the LARGEST j with cand[j] >= m and score[q, j] > NEG
//             (ties go to the longest token); if there is none, best_l = 1
//             and dp = NEG
//   hist    <- [start[q] ? 0 : dp, hist[0], ..., hist[L-2]]
//
// What bounds it on the H100: bytes. Every score of the (C, L, B) slab is
// read once and takes one add and one compare, so the kernel does about
// 3 operations per 4 bytes read; the device-memory rate is the roof.
//
// What the design does about it: one thread per packed row. The L-deep
// history lives in registers and the loop over the C positions runs inside
// the thread (the TPU kernel's sequential grid). The slab is laid out
// (C, L, B): neighbouring threads read neighbouring rows, so each warp's
// load of one (position, length) is one 128-byte transaction and every slab
// byte crosses the memory bus once. The whole chunk is one launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tokengeex_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TGX_NEG (-3.0e38f)

template <int LMAX>
__global__ void viterbi_chunk_kernel(const float* __restrict__ score,   // (C, L, B)
                                     const float* __restrict__ starts,  // (C, B)
                                     const float* __restrict__ hist_in, // (L, B)
                                     float* __restrict__ dp,            // (C, B)
                                     int32_t* __restrict__ best_l,      // (C, B)
                                     float* __restrict__ hist_out,      // (L, B)
                                     int C, int L, int B) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  const size_t Bs = (size_t)B;

  float h[LMAX];
#pragma unroll
  for (int j = 0; j < LMAX; ++j) h[j] = (j < L) ? hist_in[j * Bs + r] : TGX_NEG;

  for (int q = 0; q < C; ++q) {
    const float* sq = score + (size_t)q * L * Bs + r;
    float s[LMAX];
    float cand[LMAX];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < LMAX; ++j) {
      if (j < L) {
        s[j] = sq[j * Bs];
        cand[j] = h[j] + s[j];
        m = fmaxf(m, cand[j]);
      }
    }
    int jbest = -1;
#pragma unroll
    for (int j = 0; j < LMAX; ++j) {
      if (j < L && cand[j] >= m && s[j] > TGX_NEG) jbest = j;
    }
    const float v = (jbest >= 0) ? m : TGX_NEG;
    dp[q * Bs + r] = v;
    best_l[q * Bs + r] = (jbest >= 0) ? jbest + 1 : 1;
    const float carry = (starts[q * Bs + r] > 0.5f) ? 0.0f : v;
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
                   float* dp, int32_t* best_l, float* hist_out, int C, int L, int B,
                   cudaStream_t stream) {
  const int threads = 32;  // one warp per block: rows spread over SMs
  const int blocks = (B + threads - 1) / threads;
  viterbi_chunk_kernel<LMAX><<<blocks, threads, 0, stream>>>(
      score, starts, hist_in, dp, best_l, hist_out, C, L, B);
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tgx_viterbi_chunk(const float* score, const float* starts,
                                 const float* hist_in, float* dp, int32_t* best_l,
                                 float* hist_out, int C, int L, int B, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (L <= 8) {
    launch<8>(score, starts, hist_in, dp, best_l, hist_out, C, L, B, s);
  } else if (L <= 16) {
    launch<16>(score, starts, hist_in, dp, best_l, hist_out, C, L, B, s);
  } else if (L <= 32) {
    launch<32>(score, starts, hist_in, dp, best_l, hist_out, C, L, B, s);
  } else if (L <= 64) {
    launch<64>(score, starts, hist_in, dp, best_l, hist_out, C, L, B, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
