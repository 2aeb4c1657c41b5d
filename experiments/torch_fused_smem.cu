// Design probe for tokengeex_tpu_torch's fused log-sum-exp scans (not
// built by the package): csrc/fused_forward.cu's `fused_lse_scan_kernel`
// and csrc/fused_backward.cu's `fused_backward_scan_kernel`, the same
// bodies, with both cuckoo tables staged into dynamic shared memory once
// per block of NW = 16 warps instead of read from global memory through
// L2 and L1. Tables of at most 13 bits: 2 x 8,192 rows x 8 bytes = 128
// KB, under the 227 KB a block may hold, so one block per SM holds them
// once for 16 warps. Run by experiments/torch_scan_design.py on the card,
// which holds it equal to the package's kernels bit for bit and times the
// two in turns.
//
// The entry points take the package's arguments (ops/_build.py
// "fused_forward_lse" and "fused_backward") and refuse tables of more
// than 13 bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o <lib> experiments/torch_fused_smem.cu

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "../tokengeex_tpu_torch/csrc/fused_probe.cuh"

#define NW 16        // warps per block
#define MAX_BITS 13  // the largest tables staged

// Both tables staged into the block's dynamic shared memory, T1 rows then
// T2 rows. Every thread of the block constructs it.
struct StagedTables {
  const int2* t1;
  const int2* t2;
  __device__ __forceinline__ StagedTables(const int2* g1, const int2* g2,
                                          int bits) {
    extern __shared__ int2 tab_s[];
    const int H = 1 << bits;
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      tab_s[i] = g1[i];
      tab_s[H + i] = g2[i];
    }
    __syncthreads();
    t1 = tab_s;
    t2 = tab_s + H;
  }
  __device__ __forceinline__ int2 row1(uint32_t i) const { return t1[i]; }
  __device__ __forceinline__ int2 row2(uint32_t i) const { return t2[i]; }
};

template <int LMAX, int G, bool DROP>
__global__ void __launch_bounds__(32 * NW)
fused_lse_smem_kernel(
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
    float* __restrict__ a,               // (W, B) forward values
    int32_t* __restrict__ rl_out,        // (B,) run length after byte W - 1
    int W, int L, int B, int K, int pad, int bits, uint32_t thr_half) {
  constexpr int P = LMAX / G;   // lengths per lane: j = g + G * p
  constexpr int CH = 32 / G;    // chains (rows) per warp
  constexpr int D = TGX_FUSED_D;
  // By warp and step parity (one barrier a step), rows 16-byte aligned.
  __shared__ __align__(16) float e_s[NW][2][CH][SumRow<LMAX>::stride];
  const StagedTables tab(t1, t2, bits);
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = lane % G;
  const int c = lane / G;
  const int groups = (B + CH - 1) / CH;
  const int unit = blockIdx.x * NW + w;  // (segment, 32/G rows) of this warp
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
      g1[i][p] = tab.row1(tgx_slot1(fp1, l, shift));
      g2[i][p] = tab.row2(tgx_slot2(fp2, l, shift));
      gf[i][p] = tgx_check(fp1, fp2);
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
          h, hx, h0, sc, s0, grs[i], &e_s[w][q & 1][c][0], g, L);
      if (g == 0 && q >= b0 && q < b1) a[(size_t)q * Bs + r] = lse;
      probe(i, q + D);  // the slot is consumed: refill both rings
      fetch(i, q + 2 * D);
    }
  }
}

template <int LMAX, int G, bool DROP>
__global__ void __launch_bounds__(32 * NW)
fused_backward_smem_kernel(
    const int2* __restrict__ t1,         // (H,) rows [check, f32 score bits]
    const int2* __restrict__ t2,         // (H,)
    const int32_t* __restrict__ p1,      // (pad + W + 1 + pad, B) prefix hashes R1
    const int32_t* __restrict__ p2,      // same for R2
    const int32_t* __restrict__ rinv1,   // (pad + W,) inverse powers R1
    const int32_t* __restrict__ rinv2,   // (pad + W,)
    const int32_t* __restrict__ sid,     // (pad + W + pad, B) sample ids, < 0 outside
    const uint8_t* __restrict__ is_start,// (W + 1, B)
    const uint8_t* __restrict__ is_end,  // (W + 1, B)
    const int32_t* __restrict__ du,      // (pad + W + pad, B) dropout words (DROP only)
    const int32_t* __restrict__ seg,     // (K+1, B) chain bounds, or null (K = 1)
    float* __restrict__ betas,           // (W, B) post-reset betas
    int W, int L, int B, int K, int pad, int bits, uint32_t thr_half) {
  constexpr int P = LMAX / G;   // lengths per lane: j = g + G * p
  constexpr int CH = 32 / G;    // chains (rows) per warp
  constexpr int D = TGX_FUSED_D;
  // By warp and step parity (one barrier a step), rows 16-byte aligned.
  __shared__ __align__(16) float e_s[NW][2][CH][SumRow<LMAX>::stride];
  const StagedTables tab(t1, t2, bits);
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = lane % G;
  const int c = lane / G;
  const int groups = (B + CH - 1) / CH;
  const int unit = blockIdx.x * NW + w;  // (segment, 32/G rows) of this warp
  const int k = unit / groups;
  const int r = (unit % groups) * CH + c;
  const bool row = r < B && k < K;
  const int rr = row ? r : 0;  // lanes without a row load row 0's words
  const size_t Bs = (size_t)B;
  const int shift = 32 - bits;

  // This lane's chain [b0, b1), walked downwards from b1 - 1.
  int b0 = INT_MAX, b1 = INT_MAX;
  if (row) tgx_chain(seg, k, r, Bs, W, b0, b1);
  const int lo = __reduce_min_sync(TGX_FULL, b0);
  const int hi = __reduce_max_sync(TGX_FULL, row ? b1 : INT_MIN);
  if (lo >= hi) return;

  // Stream ring: the start words of step t, loaded 2D steps ahead.
  uint32_t ss1[D], ss2[D], sr1[D], sr2[D], sdu[DROP ? D : 1];
  int32_t ssid[D];
  uint8_t snx[D], sen[D];
  auto fetch = [&](int i, int t) {
    if (t >= lo) {
      const size_t pt = (size_t)(pad + t);
      ss1[i] = (uint32_t)p1[pt * Bs + rr];
      ss2[i] = (uint32_t)p2[pt * Bs + rr];
      sr1[i] = (uint32_t)rinv1[pt];
      sr2[i] = (uint32_t)rinv2[pt];
      if constexpr (DROP) sdu[i] = (uint32_t)du[pt * Bs + rr];
      ssid[i] = sid[pt * Bs + rr];
      snx[i] = is_start[(size_t)(t + 1) * Bs + rr];
      sen[i] = is_end[(size_t)t * Bs + rr];
    }
  };

  // The probe's state one step behind its next step t (descending): lane
  // j holds the end hash P[t+2+j] (clamped to the padded rows), every lane
  // P[t+1] and the run length at t + 1.
  const size_t last = (size_t)(2 * pad + W);
  uint32_t ph1[P], ph2[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const size_t i0 = (size_t)(pad + hi + 1 + g + G * p);
    const size_t ix = i0 < last ? i0 : last;
    ph1[p] = (uint32_t)p1[ix * Bs + rr];
    ph2[p] = (uint32_t)p2[ix * Bs + rr];
  }
  uint32_t pin1 = (uint32_t)p1[(size_t)(pad + hi) * Bs + rr];
  uint32_t pin2 = (uint32_t)p2[(size_t)(pad + hi) * Bs + rr];
  int fr = 0;

  // Probe ring: step t's gathered rows, check words, validity bits and end flag.
  int2 g1[D][P], g2[D][P];
  uint32_t gf[D][P], gok[D];
  bool gen[D];
  auto probe = [&](int i, int t) {
    tgx_roll<LMAX, G>(ph1, pin1, g);
    tgx_roll<LMAX, G>(ph2, pin2, g);
    // A chain's top byte is followed by a sample end or padding: fr
    // restarts there.
    const bool fresh = snx[i] != 0 || t == b1 - 1;
    fr = (ssid[i] >= 0) ? 1 + (fresh ? 0 : fr) : 0;
    pin1 = ss1[i];
    pin2 = ss2[i];
    const uint32_t rv1 = sr1[i], rv2 = sr2[i];
    uint32_t ok = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int j = g + G * p;
      const uint32_t l = (uint32_t)(j + 1);
      const uint32_t fp1 = (ph1[p] - pin1) * rv1;
      const uint32_t fp2 = (ph2[p] - pin2) * rv2;
      g1[i][p] = tab.row1(tgx_slot1(fp1, l, shift));
      g2[i][p] = tab.row2(tgx_slot2(fp2, l, shift));
      gf[i][p] = tgx_check(fp1, fp2);
      bool v = j < L && (int)l <= fr;
      if constexpr (DROP) v = v && !tgx_dropped(sdu[i], j, thr_half);
      ok |= (uint32_t)v << p;
    }
    gok[i] = ok;
    gen[i] = sen[i] != 0;
  };

  // The history, as `tgx_lse_step` keeps it.
  float h[P], hx[P];
#pragma unroll
  for (int p = 0; p < P; ++p) h[p] = hx[p] = TGX_NEG;
  float h0 = TGX_NEG;  // hist[0], on every lane of the group

#pragma unroll
  for (int i = 0; i < D; ++i) fetch(i, hi - 1 - i);
#pragma unroll
  for (int i = 0; i < D; ++i) probe(i, hi - 1 - i);
#pragma unroll
  for (int i = 0; i < D; ++i) fetch(i, hi - 1 - D - i);

  for (int q0 = hi - 1; q0 >= lo; q0 -= D) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int q = q0 - i;
      if (q < lo) break;  // uniform over the warp
      if (q == b1 - 1) {  // chain start: the row's end, or a reset's
        const float top = (b1 == W)
            ? (is_end[(size_t)W * Bs + r] != 0 ? 0.0f : TGX_NEG) : 0.0f;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          h[p] = (g + G * p == 0) ? top : TGX_NEG;
          hx[p] = h[p];
        }
        h0 = top;
      }
      float sc[P];
#pragma unroll
      for (int p = 0; p < P; ++p)
        sc[p] = tgx_probe_score(g1[i][p], g2[i][p], gf[i][p],
                                (gok[i] >> p) & 1u);
      // The length-1 score, from the group's lane 0, on every lane.
      const float s0 = (G == 1) ? sc[0] : __shfl_sync(TGX_FULL, sc[0], 0, G);
      const float lse = tgx_lse_step<LMAX, G>(
          h, hx, h0, sc, s0, gen[i], &e_s[w][q & 1][c][0], g, L);
      if (g == 0 && q >= b0 && q < b1)
        betas[(size_t)q * Bs + r] = gen[i] ? 0.0f : lse;
      probe(i, q - D);  // the slot is consumed: refill both rings
      fetch(i, q - 2 * D);
    }
  }
}

// One launch of `kernel` over K * ceil(B / (32 / G)) warps, NW a block,
// with the tables' bytes of dynamic shared memory.
template <int G, typename Kernel, typename... Args>
static int launch_staged(Kernel kernel, int B, int K, int bits,
                         cudaStream_t stream, Args... args) {
  const int units = K * ((B + 32 / G - 1) / (32 / G));
  const size_t smem = (size_t)2 * sizeof(int2) << bits;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(units + NW - 1) / NW, 32 * NW, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

extern "C" int tgx_fused_forward_lse_smem(
    const int32_t* t1, const int32_t* t2, const int32_t* p1, const int32_t* p2,
    const int32_t* rinv1, const int32_t* rinv2, const int32_t* sid,
    const uint8_t* is_start, const int32_t* du, const float* hist_in,
    const int32_t* rl_in, const int32_t* seg, float* a, int32_t* rl_out,
    int W, int L, int B, int K, int pad, int bits, int drop,
    unsigned int thr_half, void* stream) {
  if (bits > MAX_BITS) return (int)cudaErrorInvalidValue;
  const int2* x = reinterpret_cast<const int2*>(t1);
  const int2* y = reinterpret_cast<const int2*>(t2);
  cudaStream_t s = (cudaStream_t)stream;
#define TGX_LAUNCH(LM, GG)                                                   \
  return drop ? launch_staged<GG>(fused_lse_smem_kernel<LM, GG, true>, B, K, \
                                  bits, s, x, y, p1, p2, rinv1, rinv2, sid,  \
                                  is_start, du, hist_in, rl_in, seg, a,      \
                                  rl_out, W, L, B, K, pad, bits,             \
                                  (uint32_t)thr_half)                        \
              : launch_staged<GG>(fused_lse_smem_kernel<LM, GG, false>, B,   \
                                  K, bits, s, x, y, p1, p2, rinv1, rinv2,    \
                                  sid, is_start, du, hist_in, rl_in, seg, a, \
                                  rl_out, W, L, B, K, pad, bits,             \
                                  (uint32_t)thr_half)
  TGX_SCAN_DISPATCH(L, TGX_LAUNCH);
#undef TGX_LAUNCH
}

extern "C" int tgx_fused_backward_smem(
    const int32_t* t1, const int32_t* t2, const int32_t* p1, const int32_t* p2,
    const int32_t* rinv1, const int32_t* rinv2, const int32_t* sid,
    const uint8_t* is_start, const uint8_t* is_end, const int32_t* du,
    const int32_t* seg, float* betas, int W, int L, int B, int K, int pad,
    int bits, int drop, unsigned int thr_half, void* stream) {
  if (bits > MAX_BITS) return (int)cudaErrorInvalidValue;
  const int2* x = reinterpret_cast<const int2*>(t1);
  const int2* y = reinterpret_cast<const int2*>(t2);
  cudaStream_t s = (cudaStream_t)stream;
#define TGX_LAUNCH(LM, GG)                                                    \
  return drop ? launch_staged<GG>(fused_backward_smem_kernel<LM, GG, true>,   \
                                  B, K, bits, s, x, y, p1, p2, rinv1, rinv2,  \
                                  sid, is_start, is_end, du, seg, betas, W,   \
                                  L, B, K, pad, bits, (uint32_t)thr_half)     \
              : launch_staged<GG>(fused_backward_smem_kernel<LM, GG, false>,  \
                                  B, K, bits, s, x, y, p1, p2, rinv1, rinv2,  \
                                  sid, is_start, is_end, du, seg, betas, W,   \
                                  L, B, K, pad, bits, (uint32_t)thr_half)
  TGX_SCAN_DISPATCH(L, TGX_LAUNCH);
#undef TGX_LAUNCH
}
