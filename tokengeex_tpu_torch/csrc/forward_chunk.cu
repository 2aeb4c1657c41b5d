// Forward (log-sum-exp) DP of the EM E-step as a sample-parallel scan, for
// Hopper (sm_90a).
//
// Replaces: tokengeex_tpu/ops/lattice_pallas.py `forward_chunk`
// (kernel `_forward_kernel`).
//
// What it computes, per packed row and dp step q (j = token length - 1,
// s[q, j] = the score of the token of length j+1 ENDING at dp index q+1):
//   cand[j] = hist[j] + s[q, j]
//   m       = max_j cand[j];  has = m > NEG / 2;  safe = has ? m : 0
//   t       = sum_j expf(cand[j] - safe)      (j ascending)
//   a[q]    = has ? safe + logf(t) : NEG
//   hist    <- [reset[q] ? 0 : a[q], hist[0], ..., hist[L-2]]
// reset[q] is 1.0 where dp index q+1 starts a sample. NEG = -3e38 stands
// for "no path"; NEG + NEG rounds to -inf, which the max and the `has`
// test absorb. Scores are clamped to NEG here (fmaxf), so the -inf of a
// miss never meets an add. expf/logf are the full-precision library
// functions (no fast math): the alphas feed marginals exp(a + s + b - z)
// whose exponent is a difference of values in the thousands.
//
// Two views of the scores, one body:
//   - whole width (the E-step): s[q, j] = cache[q - j, j, r] read straight
//     from the session's START-indexed (W, L, B) score cache (NEG where
//     q - j < 0), a length stride of B - L*B;
//   - chunk (`forward_chunk`): an END-indexed (C, L, B) slab, stride B.
// Dropout (whole width only) draws each token's coin here from the
// dropout words du, keyed on the token's start s = q - j: a token of
// length l > 1 is dropped iff ((du[pad + s] * (l * 2654435761)) >>> 1) <
// thr >>> 1 (uint32 arithmetic), the coin of lattice.py `_match_slab`.
//
// Chains. The probe masks every token that crosses a sample boundary or
// covers a padding byte, so at a sample start (or a padding byte) the
// history older than the step meets only NEG scores and adds expf(.) = 0
// exactly: the DP after it depends on nothing before it, bit for bit. A
// row is therefore cut into chains at seg[k, r] (k = 1..K-1, the first
// sample start or padding byte at or after k*S; seg[0] = 0, seg[K] = n):
// chain 0 starts from hist_in, every other from [0, NEG, ...]. K = 1
// without a table (the chunk API).
//
// What bounds it on the H100: the recurrence. Bytes are ~4 per (position,
// length) read once (0.09 ms for a 8192 x 16 x 512 group at 3.35 TB/s),
// but step q needs step q-1's value, so the floor is the longest chain's
// steps times one step's latency.
//
// What the design does about it: chains in parallel (a 512-row group cut
// at S = 1024 gives 4,096 where the chunked kernel had 512), and one
// chain's lengths spread over a group of G lanes (scan_lanes.cuh), so a
// step's L loads and L expf run side by side; the max goes by shuffles,
// the sum in ascending j through shared memory (the twin's order), and
// every lane of the group computes the step's value itself, so nothing
// but the max's butterfly sits between two steps. The length-1 score and
// the reset flag are loaded by every lane of a group, so the new history
// head (the only value that depends on the last step) needs no shuffle:
// cand[0] = carry + s[q, 0] is formed on every lane. A warp holds 32 / G
// neighbouring rows of one segment and walks the union of their chains in
// lockstep (a lane outside its chain computes but does not write), so
// every load of one (position, length) serves 32 / G rows at once. Loads
// do not depend on the DP: each lane issues them D steps ahead into a
// register ring. G = 16 at L <= 16 (one lane per length); G = 1 is one
// thread per chain, the layout it was measured against (PERF.md).
//
// Float type: the kernel is templated on F, float everywhere and double
// for the f64 / exact conformance E-step (`tgx_forward_scan_f64`): double
// exp and log in full precision, the sentinel's value in double.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tokengeex_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "scan_lanes.cuh"

template <typename F, int LMAX, int G, bool DROP>
__global__ void __launch_bounds__(32) forward_scan_kernel(
    const F* __restrict__ score,    // (n, L, B) cache or end-indexed slab
    const F* __restrict__ reset,    // (n, B) 1.0 where dp index q+1 starts
    const F* __restrict__ hist_in,  // (L, B)
    const int32_t* __restrict__ seg,    // (K+1, B) chain starts, or null
    const int32_t* __restrict__ du,     // (pad + n + pad, B), DROP only
    F* __restrict__ a,              // (n, B)
    F* __restrict__ hist_out,       // (L, B), or null (K == 1 only)
    int n, int L, int B, int start_indexed, int pad, uint32_t thr_half) {
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
  const size_t Bs = (size_t)B;

  // This lane's chain [b0, b1); the warp walks the union of its chains'.
  int b0 = INT_MAX, b1 = INT_MAX;
  if (row) tgx_chain(seg, k, r, Bs, n, b0, b1);
  const int lo = __reduce_min_sync(TGX_FULL, b0);
  const int hi = __reduce_max_sync(TGX_FULL, row ? b1 : INT_MIN);
  if (lo >= hi) return;

  // s[q, j] lives at q * qs + j * js + r; a start-indexed cache has no
  // token starting before 0 (q - j < jlo).
  const long long qs = (long long)L * B;
  const long long js = start_indexed ? (long long)B - qs : (long long)B;
  const int jlo = start_indexed ? 0 : -LMAX;

  // The ring, D steps deep: this lane's P scores, the length-1 score, the
  // reset flag, and the dropout words of the lane's P tokens.
  F rs[D][P], r0[D], rf[D];
  uint32_t ru[DROP ? D : 1][DROP ? P : 1];
  auto fetch = [&](int i, int q) {
    if (row && q < hi) {
      const F* sq = score + (long long)q * qs + r;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int j = g + G * p;
        rs[i][p] = (j < L && q - j >= jlo) ? sq[j * js] : NEG;
        if constexpr (DROP)
          ru[i][p] = (j < L) ? (uint32_t)du[(size_t)(pad + q - j) * Bs + r] : 0u;
      }
      r0[i] = sq[0];
      rf[i] = reset[(size_t)q * Bs + r];
    }
  };

  // The history, as `tgx_lse_step` keeps it.
  F h[P], hx[P];
#pragma unroll
  for (int p = 0; p < P; ++p) h[p] = hx[p] = NEG;
  F h0 = NEG;  // hist[0], on every lane of the group

#pragma unroll
  for (int i = 0; i < D; ++i) fetch(i, lo + i);

  for (int q0 = lo; q0 < hi; q0 += D) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int q = q0 + i;
      if (q >= hi) break;  // uniform over the warp
      if (q == b0) {  // chain start: the row's history, or a reset's
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int j = g + G * p;
          h[p] = (j >= L) ? NEG
               : (b0 == 0) ? hist_in[j * Bs + r]
               : (j == 0 ? F(0) : NEG);
          hx[p] = h[p];
        }
        h0 = (b0 == 0) ? hist_in[r] : F(0);
      }
      F sc[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        sc[p] = tgx_max(rs[i][p], NEG);
        if constexpr (DROP)
          if (tgx_dropped(ru[i][p], g + G * p, thr_half)) sc[p] = NEG;
      }
      // Length 1 draws no coin.
      const F lse = tgx_lse_step<LMAX, G>(
          h, hx, h0, sc, tgx_max(r0[i], NEG), rf[i] > F(0.5),
          &e_s[q & 1][c][0], g, L);
      if (g == 0 && q >= b0 && q < b1) a[(size_t)q * Bs + r] = lse;
      fetch(i, q + D);  // the slot is consumed: refill it
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
static int launch(const F* score, const F* reset, const F* hist_in,
                  const int32_t* seg, const int32_t* du, F* a, F* hist_out,
                  int n, int L, int B, int K, int start_indexed, int pad,
                  uint32_t thr_half, bool drop, cudaStream_t stream) {
  const int blocks = K * ((B + 32 / G - 1) / (32 / G));  // warp per (segment, 32/G rows)
  if (drop) {
    forward_scan_kernel<F, LMAX, G, true><<<blocks, 32, 0, stream>>>(
        score, reset, hist_in, seg, du, a, hist_out, n, L, B, start_indexed,
        pad, thr_half);
  } else {
    forward_scan_kernel<F, LMAX, G, false><<<blocks, 32, 0, stream>>>(
        score, reset, hist_in, seg, du, a, hist_out, n, L, B, start_indexed,
        pad, thr_half);
  }
  return (int)cudaGetLastError();
}

template <typename F>
static int scan(const F* score, const F* reset, const F* hist_in,
                const int32_t* seg, const int32_t* du, F* a, F* hist_out,
                int n, int L, int B, int K, int start_indexed, int pad,
                unsigned thr_half, int use_drop, void* stream) {
#define TGX_LAUNCH(LM, GG)                                                   \
  return launch<F, LM, GG>(score, reset, hist_in, seg, du, a, hist_out, n,   \
                           L, B, K, start_indexed, pad, thr_half,            \
                           use_drop != 0, (cudaStream_t)stream)
  TGX_SCAN_DISPATCH(L, TGX_LAUNCH);
#undef TGX_LAUNCH
}

extern "C" int tgx_forward_scan(const float* score, const float* reset,
                                const float* hist_in, const int32_t* seg,
                                const int32_t* du, float* a, float* hist_out,
                                int n, int L, int B, int K, int start_indexed,
                                int pad, unsigned thr_half, int use_drop,
                                void* stream) {
  return scan<float>(score, reset, hist_in, seg, du, a, hist_out, n, L, B, K,
                     start_indexed, pad, thr_half, use_drop, stream);
}

// The same scan in double (the f64 / exact conformance route): double
// exp and log in full precision.
extern "C" int tgx_forward_scan_f64(const double* score, const double* reset,
                                    const double* hist_in,
                                    const int32_t* seg, const int32_t* du,
                                    double* a, double* hist_out, int n, int L,
                                    int B, int K, int start_indexed, int pad,
                                    unsigned thr_half, int use_drop,
                                    void* stream) {
  return scan<double>(score, reset, hist_in, seg, du, a, hist_out, n, L, B,
                      K, start_indexed, pad, thr_half, use_drop, stream);
}
