// Vocabulary probe fused with the backward (log-sum-exp) DP, for Hopper
// (sm_90a).
//
// Replaces: tokengeex_tpu/ops/lattice_pallas_fused.py `fused_backward_chunk`
// (`_make_fused_bwd_kernel`).
//
// What it computes, per packed row, walking byte positions q from W-1 down
// to 0 (token of length l = j+1 STARTING at q, i.e. ending at dp index q+l;
// hist[j] = beta at dp index q+1+j):
//   fp     = (P[q+l] - P[q]) * rinv[q]                  (two hash families)
//   idx    = ((fp ^ l*A) * M) >>> (32 - bits)
//   score  = T1 hit ? T1 score : T2 hit ? T2 score : miss, with the empty-
//            slot guard of fused_forward.cu;
//   fr     = run length STARTING at q with no internal sample start:
//            fr = inb(q) ? 1 + (is_start[q+1] ? 0 : fr(q+1)) : 0;
//   valid  = l <= fr, and, with dropout, the coin u = (du[q] * odd_l) >>> 1
//            is not below thr >>> 1 (l > 1): keyed on the token's start;
//   cand[j] = score + hist[j];  m = max;  has = m > NEG/2;  safe = has ? m : 0
//   beta   = has ? safe + logf(sum_j expf(cand[j] - safe)) : NEG
//   out[q] = end[q] ? 0 : beta;  hist <- [out[q], hist[0], ..., hist[L-2]]
// hist starts as [end[W] ? 0 : NEG, NEG, ...]. expf/logf are the
// full-precision library functions (no fast math).
//
// What bounds it on the H100: bytes and L2 gathers. The streams cost ~18-22
// bytes per (position, row): two prefix hashes, the sample id, the start and
// end flags, the optional dropout word, and the beta out. The probe adds up
// to 2 * L gathers of 8-byte table rows per (position, row); at bits <= 15
// both tables total <= 512 KB and stay resident in the 50 MB L2.
//
// What the design does about it: as fused_forward.cu. One thread per packed
// row walks the whole width in one launch, so the TPU kernel's per-chunk
// carries (the forward prefix-hash history phf, the run length fr and the
// next-start flag sn) are registers or L1 hits: the L prefix hashes P[q+l]
// a step needs were loaded by the L steps before it. All row streams are
// (position, row), so each warp's stream load is one 128-byte transaction.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tokengeex_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TGX_NEG (-3.0e38f)

// f32 -3.0e38 as int32 bits: the empty-slot score sentinel.
#define TGX_NEG_BITS ((int32_t)0xFF61B1E6)

#define TGX_IDX_A1 0x27D4EB2Fu
#define TGX_IDX_M1 0x165667B1u
#define TGX_IDX_A2 0x9E3779B9u
#define TGX_IDX_M2 0xC2B2AE35u
#define TGX_ODD 2654435761u

template <int LMAX, bool DROP>
__global__ void fused_backward_kernel(
    const int2* __restrict__ t1,         // (H,) rows [check = fp2, f32 score bits]
    const int2* __restrict__ t2,         // (H,)
    const int32_t* __restrict__ p1,      // (pad + W + 1 + pad, B) prefix hashes R1
    const int32_t* __restrict__ p2,      // same for R2
    const int32_t* __restrict__ rinv1,   // (pad + W,) inverse powers R1
    const int32_t* __restrict__ rinv2,   // (pad + W,)
    const int32_t* __restrict__ sid,     // (pad + W + pad, B) sample ids, < 0 outside
    const uint8_t* __restrict__ is_start,// (W + 1, B)
    const uint8_t* __restrict__ is_end,  // (W + 1, B)
    const int32_t* __restrict__ du,      // (pad + W + pad, B) dropout words (DROP only)
    float* __restrict__ betas,           // (W, B) post-reset betas
    int W, int L, int B, int pad, int bits, uint32_t thr_half) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  const size_t Bs = (size_t)B;
  const int shift = 32 - bits;

  float h[LMAX];
#pragma unroll
  for (int j = 0; j < LMAX; ++j) h[j] = TGX_NEG;
  h[0] = (is_end[(size_t)W * Bs + r] != 0) ? 0.0f : TGX_NEG;
  int fr = 0;

  for (int q = W - 1; q >= 0; --q) {
    const bool inb = sid[(size_t)(pad + q) * Bs + r] >= 0;
    const bool sn = is_start[(size_t)(q + 1) * Bs + r] != 0;
    fr = inb ? 1 + (sn ? 0 : fr) : 0;
    const size_t sp = (size_t)(pad + q);
    const uint32_t s1 = (uint32_t)p1[sp * Bs + r];
    const uint32_t s2 = (uint32_t)p2[sp * Bs + r];
    const uint32_t rv1 = (uint32_t)rinv1[sp];
    const uint32_t rv2 = (uint32_t)rinv2[sp];
    uint32_t dq = 0;
    if (DROP) dq = (uint32_t)du[sp * Bs + r];

    float cand[LMAX];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < LMAX; t += 8) {
      if (t >= L) break;  // uniform: every thread has the same L
      // As in fused_forward.cu: all loads of a tile of 8 lengths issue
      // before any select, so the 8 end hashes, then the 16 table rows,
      // are in flight together.
      uint32_t fp2v[8];
      int2 r1v[8];
      int2 r2v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t l = (uint32_t)(t + k + 1);
        // P[q + l]: inside the right pad for l <= L; the lengths of the
        // last tile past L (dropped below) read the last row instead.
        const size_t last = (size_t)(2 * pad + W);
        const size_t e = (sp + l < last) ? sp + l : last;
        const uint32_t fp1 = ((uint32_t)p1[e * Bs + r] - s1) * rv1;
        const uint32_t fp2 = ((uint32_t)p2[e * Bs + r] - s2) * rv2;
        fp2v[k] = fp2;
        r1v[k] = t1[((fp1 ^ (l * TGX_IDX_A1)) * TGX_IDX_M1) >> shift];
        r2v[k] = t2[((fp2 ^ (l * TGX_IDX_A2)) * TGX_IDX_M2) >> shift];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = t + k;
        const uint32_t l = (uint32_t)(j + 1);
        int32_t sb = TGX_NEG_BITS;
        if ((uint32_t)r2v[k].x == fp2v[k]) sb = r2v[k].y;
        if ((uint32_t)r1v[k].x == fp2v[k] && r1v[k].y != TGX_NEG_BITS) sb = r1v[k].y;
        bool ok = j < L && (int)l <= fr;
        if (DROP) {
          const uint32_t u = (dq * (l * TGX_ODD)) >> 1;
          if (l > 1 && u < thr_half) ok = false;
        }
        const float sf = __int_as_float(sb);
        const float sc = (ok && sf > TGX_NEG * 0.5f) ? sf : TGX_NEG;
        cand[j] = (j < L) ? sc + h[j] : -INFINITY;
        m = fmaxf(m, cand[j]);
      }
    }
    const bool has = m > TGX_NEG * 0.5f;
    const float safe = has ? m : 0.0f;
    float tsum = 0.0f;
#pragma unroll
    for (int j = 0; j < LMAX; ++j) {
      if (j < L) tsum += expf(cand[j] - safe);
    }
    const float lse = has ? safe + logf(tsum) : TGX_NEG;
    const float b = (is_end[(size_t)q * Bs + r] != 0) ? 0.0f : lse;
    betas[(size_t)q * Bs + r] = b;
#pragma unroll
    for (int j = LMAX - 1; j > 0; --j) h[j] = h[j - 1];
    h[0] = b;
  }
}

template <int LMAX>
static void launch(bool drop, const int2* t1, const int2* t2, const int32_t* p1,
                   const int32_t* p2, const int32_t* rinv1, const int32_t* rinv2,
                   const int32_t* sid, const uint8_t* is_start, const uint8_t* is_end,
                   const int32_t* du, float* betas, int W, int L, int B, int pad,
                   int bits, uint32_t thr_half, cudaStream_t stream) {
  const int threads = 32;  // one warp per block: rows spread over SMs
  const int blocks = (B + threads - 1) / threads;
  if (drop) {
    fused_backward_kernel<LMAX, true><<<blocks, threads, 0, stream>>>(
        t1, t2, p1, p2, rinv1, rinv2, sid, is_start, is_end, du, betas, W, L, B, pad,
        bits, thr_half);
  } else {
    fused_backward_kernel<LMAX, false><<<blocks, threads, 0, stream>>>(
        t1, t2, p1, p2, rinv1, rinv2, sid, is_start, is_end, du, betas, W, L, B, pad,
        bits, thr_half);
  }
}

// du may be null when drop == 0. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int tgx_fused_backward(
    const int32_t* t1, const int32_t* t2, const int32_t* p1, const int32_t* p2,
    const int32_t* rinv1, const int32_t* rinv2, const int32_t* sid,
    const uint8_t* is_start, const uint8_t* is_end, const int32_t* du,
    float* betas, int W, int L, int B, int pad, int bits, int drop,
    unsigned int thr_half, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int2* a = reinterpret_cast<const int2*>(t1);
  const int2* b = reinterpret_cast<const int2*>(t2);
  const bool d = drop != 0;
  if (L <= 8) {
    launch<8>(d, a, b, p1, p2, rinv1, rinv2, sid, is_start, is_end, du, betas, W, L,
              B, pad, bits, thr_half, s);
  } else if (L <= 16) {
    launch<16>(d, a, b, p1, p2, rinv1, rinv2, sid, is_start, is_end, du, betas, W, L,
               B, pad, bits, thr_half, s);
  } else if (L <= 32) {
    launch<32>(d, a, b, p1, p2, rinv1, rinv2, sid, is_start, is_end, du, betas, W, L,
               B, pad, bits, thr_half, s);
  } else if (L <= 64) {
    launch<64>(d, a, b, p1, p2, rinv1, rinv2, sid, is_start, is_end, du, betas, W, L,
               B, pad, bits, thr_half, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
