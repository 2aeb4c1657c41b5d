// Vocabulary probe fused with the Viterbi DP, for Hopper (sm_90a).
//
// Replaces: tokengeex_tpu/ops/lattice_pallas_fused.py `fused_forward_chunk`
// with kind="viterbi" (`_make_fused_fwd_kernel`, `_probe_tiles`,
// `_tile_consts`).
//
// What it computes, per packed row and dp step q (token of length l = j+1
// ending at dp index q+1, i.e. starting at byte s = q - j):
//   fp     = (P[q+1] - P[s]) * rinv[s]                  (two hash families)
//   idx    = ((fp ^ l*A) * M) >>> (32 - bits)
//   score  = T1 hit ? T1 score : T2 hit ? T2 score : miss, where a hit is
//            check == fp2, and a T1 slot holding the empty-slot score
//            sentinel never counts (a zero-check pseudo-hit on an empty
//            slot must not override a true T2 match);
//   valid  = l <= run length of the sample at q, and, with dropout, the
//            coin u = (du[s] * odd_l) >>> 1 is not below thr >>> 1 (l > 1);
//   then the Viterbi relaxation of viterbi_chunk.cu.
//
// What bounds it on the H100: bytes and L2 gathers. The streams cost ~17-21
// bytes per (position, row) (two prefix hashes, the sample id, the start
// flag, the optional dropout word, dp and best_l out). The probe adds up to
// 2 * L gathers of 8-byte table rows per (position, row); at bits <= 15 both
// tables total <= 512 KB and stay resident in the 50 MB L2, so the gathers
// are L2 transactions, not device-memory bytes.
//
// What the design does about it: one thread per packed row; the DP history
// lives in registers and the loop over positions runs inside the thread, the
// whole row width in one launch. All row streams are laid out
// (position, row), so each warp's stream load is one 128-byte transaction,
// and the L earlier prefix hashes a step needs were loaded by the previous
// steps and hit L1. Each probe is a direct gather of one (check, score) row
// per table -- the TPU kernel's linear scan over every table row existed
// only because its tables sat in VMEM. A step's lengths go in tiles of 8
// whose loads carry no row-dependent branch, so they overlap.
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
__global__ void fused_forward_kernel(
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
        r1v[k] = t1[((fp1 ^ (l * TGX_IDX_A1)) * TGX_IDX_M1) >> shift];
        r2v[k] = t2[((fp2 ^ (l * TGX_IDX_A2)) * TGX_IDX_M2) >> shift];
        if (DROP) duv[k] = (uint32_t)du[sp * Bs + r];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = t + k;
        const uint32_t l = (uint32_t)(j + 1);
        int32_t sb = TGX_NEG_BITS;
        if ((uint32_t)r2v[k].x == fp2v[k]) sb = r2v[k].y;
        if ((uint32_t)r1v[k].x == fp2v[k] && r1v[k].y != TGX_NEG_BITS) sb = r1v[k].y;
        bool ok = j < L && (int)l <= rl;
        if (DROP) {
          const uint32_t u = (duv[k] * (l * TGX_ODD)) >> 1;
          if (l > 1 && u < thr_half) ok = false;
        }
        const float sf = __int_as_float(sb);
        const float sc = (ok && sf > TGX_NEG * 0.5f) ? sf : TGX_NEG;
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
    dp[q * Bs + r] = v;
    best_l[q * Bs + r] = (jbest >= 0) ? jbest + 1 : 1;
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

template <int LMAX>
static void launch(bool drop, const int2* t1, const int2* t2, const int32_t* p1,
                   const int32_t* p2, const int32_t* rinv1, const int32_t* rinv2,
                   const int32_t* sid, const uint8_t* is_start, const int32_t* du,
                   const float* hist_in, const int32_t* rl_in, float* dp,
                   int32_t* best_l, float* hist_out, int32_t* rl_out, int W, int L,
                   int B, int pad, int bits, uint32_t thr_half, cudaStream_t stream) {
  const int threads = 32;  // one warp per block: rows spread over SMs
  const int blocks = (B + threads - 1) / threads;
  if (drop) {
    fused_forward_kernel<LMAX, true><<<blocks, threads, 0, stream>>>(
        t1, t2, p1, p2, rinv1, rinv2, sid, is_start, du, hist_in, rl_in, dp, best_l,
        hist_out, rl_out, W, L, B, pad, bits, thr_half);
  } else {
    fused_forward_kernel<LMAX, false><<<blocks, threads, 0, stream>>>(
        t1, t2, p1, p2, rinv1, rinv2, sid, is_start, du, hist_in, rl_in, dp, best_l,
        hist_out, rl_out, W, L, B, pad, bits, thr_half);
  }
}

// du may be null when drop == 0. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int tgx_fused_forward_viterbi(
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
    launch<8>(d, a, b, p1, p2, rinv1, rinv2, sid, is_start, du, hist_in, rl_in, dp,
              best_l, hist_out, rl_out, W, L, B, pad, bits, thr_half, s);
  } else if (L <= 16) {
    launch<16>(d, a, b, p1, p2, rinv1, rinv2, sid, is_start, du, hist_in, rl_in, dp,
               best_l, hist_out, rl_out, W, L, B, pad, bits, thr_half, s);
  } else if (L <= 32) {
    launch<32>(d, a, b, p1, p2, rinv1, rinv2, sid, is_start, du, hist_in, rl_in, dp,
               best_l, hist_out, rl_out, W, L, B, pad, bits, thr_half, s);
  } else if (L <= 64) {
    launch<64>(d, a, b, p1, p2, rinv1, rinv2, sid, is_start, du, hist_in, rl_in, dp,
               best_l, hist_out, rl_out, W, L, B, pad, bits, thr_half, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
