// Backward (log-sum-exp) DP and token marginals over a probed,
// start-indexed score slab, for Hopper (sm_90a).
//
// Replaces: tokengeex_tpu/ops/lattice_pallas.py `backward_chunk`
// (kernel `_backward_kernel`).
//
// What it computes, per packed row, walking the chunk's positions q from
// C-1 down to 0 (j = token length - 1, hist[j] = beta at position q+1+j):
//   marg[q, j] = expf(max(a[q] + score[q, j] + hist[j] - z[q], NEG))
//   cand[j]    = score[q, j] + hist[j]
//   m = max_j cand[j];  has = m > NEG / 2;  safe = has ? m : 0
//   beta       = has ? safe + logf(sum_j expf(cand[j] - safe)) : NEG
//   hist       <- [end[q] ? 0 : beta, hist[0], ..., hist[L-2]]
// a[q] is the forward value of a token starting at q (0 at a sample
// start), z[q] the normaliser of q's sample. NEG = -3e38; NEG + NEG rounds
// to -inf, which max(., NEG) and the `has` test absorb. expf/logf are the
// full-precision library functions (no fast math).
//
// Betas mode (MARG = false; replaces the XLA scan `_backward_betas_impl`
// of tokengeex_tpu/ops/lattice_jax.py): the same recurrence, reading
// neither a nor z and writing the post-reset betas
//   betas[q]   = end[q] ? 0 : beta
// (C, B) instead of the marginals. The segsum count path turns them into
// expected counts.
//
// What bounds it on the H100: bytes. It reads the (C, L, B) slab once and
// writes the (C, L, B) marginals once: 8 bytes per (position, length), for
// two expf and a few adds. In betas mode it writes 4 bytes per position
// instead, so the slab read is nearly all of its traffic.
//
// What the design does about it: one thread per packed row, as in
// viterbi_chunk.cu. The L-deep beta history lives in registers and the
// descending position loop runs inside the thread (the TPU kernel's
// sequential grid). Slab and marginals are laid out (C, L, B), so each
// warp's load or store of one (position, length) is one 128-byte
// transaction. The scatter of marginals into token bins stays outside the
// kernel, so its summation order is that of the plain version.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tokengeex_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TGX_NEG (-3.0e38f)

template <int LMAX, bool MARG>
__global__ void backward_chunk_kernel(const float* __restrict__ score,    // (C, L, B)
                                      const float* __restrict__ a,        // (C, B), MARG only
                                      const float* __restrict__ z,        // (C, B), MARG only
                                      const float* __restrict__ ends,     // (C, B)
                                      const float* __restrict__ hist_in,  // (L, B)
                                      float* __restrict__ out,            // marg (C, L, B) or betas (C, B)
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
    float aq = 0.0f;
    float zq = 0.0f;
    if (MARG) {
      aq = a[q * Bs + r];
      zq = z[q * Bs + r];
    }
    float cand[LMAX];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < LMAX; ++j) {
      if (j < L) {
        const float s = score[row + j * Bs];
        if (MARG) out[row + j * Bs] = expf(fmaxf(aq + s + h[j] - zq, TGX_NEG));
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
    if (!MARG) out[q * Bs + r] = carry;
#pragma unroll
    for (int j = LMAX - 1; j > 0; --j) h[j] = h[j - 1];
    h[0] = carry;
  }

#pragma unroll
  for (int j = 0; j < LMAX; ++j)
    if (j < L) hist_out[j * Bs + r] = h[j];
}

template <int LMAX, bool MARG>
static void launch(const float* score, const float* a, const float* z,
                   const float* ends, const float* hist_in, float* out,
                   float* hist_out, int C, int L, int B, cudaStream_t stream) {
  const int threads = 32;  // one warp per block: rows spread over SMs
  const int blocks = (B + threads - 1) / threads;
  backward_chunk_kernel<LMAX, MARG><<<blocks, threads, 0, stream>>>(
      score, a, z, ends, hist_in, out, hist_out, C, L, B);
}

template <bool MARG>
static int dispatch(const float* score, const float* a, const float* z,
                    const float* ends, const float* hist_in, float* out,
                    float* hist_out, int C, int L, int B, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (L <= 8) {
    launch<8, MARG>(score, a, z, ends, hist_in, out, hist_out, C, L, B, s);
  } else if (L <= 16) {
    launch<16, MARG>(score, a, z, ends, hist_in, out, hist_out, C, L, B, s);
  } else if (L <= 32) {
    launch<32, MARG>(score, a, z, ends, hist_in, out, hist_out, C, L, B, s);
  } else if (L <= 64) {
    launch<64, MARG>(score, a, z, ends, hist_in, out, hist_out, C, L, B, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Each returns cudaGetLastError() after the launch (0 on success).
extern "C" int tgx_backward_chunk(const float* score, const float* a,
                                  const float* z, const float* ends,
                                  const float* hist_in, float* marg,
                                  float* hist_out, int C, int L, int B,
                                  void* stream) {
  return dispatch<true>(score, a, z, ends, hist_in, marg, hist_out, C, L, B,
                        stream);
}

extern "C" int tgx_backward_betas_chunk(const float* score, const float* ends,
                                        const float* hist_in, float* betas,
                                        float* hist_out, int C, int L, int B,
                                        void* stream) {
  return dispatch<false>(score, nullptr, nullptr, ends, hist_in, betas,
                         hist_out, C, L, B, stream);
}
