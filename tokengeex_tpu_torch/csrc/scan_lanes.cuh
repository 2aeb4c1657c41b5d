// Shared by the sample-parallel scans (forward_chunk.cu, backward_chunk.cu):
// one chain's L token lengths spread over a group of G lanes, P = LMAX / G
// lengths per lane (lane g holds j = g + G * p), 32 / G chains per warp.
//
// Every lane of a group computes the step's log-sum-exp itself: the max by
// a butterfly of shuffles (exact in any order), the sum of the G * P
// exponentials in ASCENDING j through shared memory, as the plain twins
// sum them, so kernel and twin round alike.
//
// The helpers take the float type F of their values: float for every
// kernel, double for the f64 instantiations of viterbi_scan, forward_scan
// and backward_marginal_scan. A float step calls what the f32-only
// helpers called (fmaxf, expf, logf, the -3e38f sentinel), so it compiles
// to the same code; a double step takes fmax, exp and log in full
// precision and the same sentinel's value in double.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define TGX_NEG (-3.0e38f)
#define TGX_ODD 2654435761u  // dropout per-length mixer
#define TGX_FULL 0xffffffffu

// Steps whose loads are in flight ahead of the recurrence, in a register
// ring (the step loop is unrolled D times, so every ring index is static).
#define TGX_SCAN_D 8

__device__ __forceinline__ float tgx_max(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double tgx_max(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float tgx_exp(float x) { return expf(x); }
__device__ __forceinline__ double tgx_exp(double x) { return exp(x); }
__device__ __forceinline__ float tgx_log(float x) { return logf(x); }
__device__ __forceinline__ double tgx_log(double x) { return log(x); }

// The sentinel "-inf" that survives the arithmetic (-3e38 as F), and -inf.
template <typename F>
__device__ __forceinline__ F tgx_neg() {
  return static_cast<F>(TGX_NEG);
}
template <typename F>
__device__ __forceinline__ F tgx_ninf() {
  return static_cast<F>(-INFINITY);
}

// A parameter of type F that takes no part in deducing F.
template <typename F>
struct tgx_same {
  using type = F;
};

// Token of length l = j + 1 > 1 is dropped iff its coin
// ((du * (l * 2654435761)) >>> 1) falls under thr >>> 1 (uint32 math).
__device__ __forceinline__ bool tgx_dropped(uint32_t du, int j,
                                            uint32_t thr_half) {
  return j > 0 && ((du * ((uint32_t)(j + 1) * TGX_ODD)) >> 1) < thr_half;
}

// Chain k of row r: [b0, b1) from the bounds seg (K+1, B), or the whole
// row [0, n) when seg is null. Clamped so that 0 <= b0 <= b1 <= n whatever
// seg holds: a bound out of range or out of order gives wrong values, never
// an access outside the buffers.
__device__ __forceinline__ void tgx_chain(const int32_t* seg, int k, int r,
                                          size_t Bs, int n, int& b0,
                                          int& b1) {
  if (seg == nullptr) {
    b0 = 0;
    b1 = n;
    return;
  }
  b0 = min(max(seg[k * Bs + r], 0), n);
  b1 = min(max(seg[(k + 1) * Bs + r], b0), n);
}

// Max over the G lanes of a group (a butterfly; the max is exact).
template <int G, typename F>
__device__ __forceinline__ F tgx_group_max(F v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v = tgx_max(v, __shfl_xor_sync(TGX_FULL, v, o, G));
  return v;
}

// Row stride, in values, of a chain's exponentials in shared memory:
// 16-byte rows for vector reads (LMAX + 4 is even, so double rows are too),
// and neighbouring chains' rows on other banks.
template <int LMAX>
struct SumRow {
  static constexpr int stride = LMAX + 4;
};

// sum_j e[j] in ascending j, 0 first, as `_lse_step` adds; e is 0 for
// j >= L, and adding +0 changes no sum, so every row adds all LMAX.
// e_s is this chain's row of shared memory (G > 1), written by every lane
// and read back whole by every lane.
template <int LMAX, int G, typename F>
__device__ __forceinline__ F tgx_ascending_sum(const F (&e)[LMAX / G],
                                               F* e_s, int g) {
  constexpr int P = LMAX / G;
  F t = F(0);
  if (G == 1) {
#pragma unroll
    for (int j = 0; j < LMAX; ++j) t += e[j];
    return t;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) e_s[g + G * p] = e[p];
  __syncwarp();
  if constexpr (std::is_same<F, float>::value) {
    const float4* v = reinterpret_cast<const float4*>(e_s);
#pragma unroll
    for (int i = 0; i < LMAX / 4; ++i) {
      const float4 x = v[i];
      t += x.x;
      t += x.y;
      t += x.z;
      t += x.w;
    }
  } else {
    const double2* v = reinterpret_cast<const double2*>(e_s);
#pragma unroll
    for (int i = 0; i < LMAX / 2; ++i) {
      const double2 x = v[i];
      t += x.x;
      t += x.y;
    }
  }
  return t;
}

// The group's history one length on: up[p] = hist[g + G*p - 1] from the
// lane before, wrap[p] = hist[G - 1 + G*p] from the group's last lane.
// Neither depends on the step's value, so a step issues them first and
// `tgx_shift` only selects once the carry is known.
template <int LMAX, int G, typename F>
__device__ __forceinline__ void tgx_neighbours(const F (&h)[LMAX / G],
                                               F (&up)[LMAX / G],
                                               F (&wrap)[LMAX / G]) {
  constexpr int P = LMAX / G;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (G == 1) {
      up[p] = p > 0 ? h[p - 1] : F(0);
      wrap[p] = h[p];
    } else {
      up[p] = __shfl_up_sync(TGX_FULL, h[p], 1, G);
      wrap[p] = __shfl_sync(TGX_FULL, h[p], G - 1, G);
    }
  }
}

// hist[j] <- hist[j-1], hist[0] <- carry, from `tgx_neighbours`' values.
template <int LMAX, int G, typename F>
__device__ __forceinline__ void tgx_shift(F (&h)[LMAX / G],
                                          const F (&up)[LMAX / G],
                                          const F (&wrap)[LMAX / G],
                                          typename tgx_same<F>::type carry,
                                          int g) {
  constexpr int P = LMAX / G;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (G == 1)
      h[p] = p > 0 ? up[p] : carry;
    else
      h[p] = (g > 0) ? up[p] : (p == 0 ? carry : wrap[p - 1]);
  }
}

// One step of a chain's log-sum-exp recurrence on its group of lanes:
//   cand[j] = hist[j] + s[j];  m = max;  has = m > NEG/2;  safe = has ? m : 0
//   value   = has ? safe + logf(sum_j expf(cand[j] - safe)) : NEG
//   hist   <- [reset ? 0 : value, hist[0], ..., hist[L-2]]
// s[p] is the score of this lane's length j = g + G*p (read for j < L, at
// least NEG), s0 the length-1 score on every lane. h holds hist[g + G*p];
// hx is the same but for hist[0], which only h0 (on every lane) and lane
// 0's h hold: hx never waits on the last step's value, so the max over
// lengths >= 2 runs a step ahead of the recurrence, and the new history
// head needs no shuffle. The history shift's shuffles issue first. e_s is
// the chain's row of shared memory for `tgx_ascending_sum`. Returns the
// value.
template <int LMAX, int G, typename F>
__device__ __forceinline__ F tgx_lse_step(F (&h)[LMAX / G], F (&hx)[LMAX / G],
                                          F& h0, const F (&s)[LMAX / G],
                                          typename tgx_same<F>::type s0,
                                          bool reset, F* e_s, int g, int L) {
  constexpr int P = LMAX / G;
  const F NEG = tgx_neg<F>();
  F up[P], wrap[P];
  tgx_neighbours<LMAX, G>(h, up, wrap);
  F cand[P];
  F m1 = tgx_ninf<F>();  // max over j >= 1: ready before the carry
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = g + G * p;
    cand[p] = tgx_ninf<F>();
    if (j < L) {
      cand[p] = hx[p] + s[p];
      if (j > 0) m1 = tgx_max(m1, cand[p]);
    }
  }
  m1 = tgx_group_max<G>(m1);
  const F c0 = h0 + s0;
  if (g == 0) cand[0] = c0;
  const F m = tgx_max(c0, m1);
  const bool has = m > NEG * F(0.5);
  const F safe = has ? m : F(0);
  F e[P];
#pragma unroll
  for (int p = 0; p < P; ++p)
    e[p] = (g + G * p < L) ? tgx_exp(cand[p] - safe) : F(0);
  const F t = tgx_ascending_sum<LMAX, G>(e, e_s, g);
  const F lse = has ? safe + tgx_log(t) : NEG;
  const F carry = reset ? F(0) : lse;
  tgx_shift<LMAX, G>(h, up, wrap, carry, g);
  tgx_shift<LMAX, G>(hx, up, wrap, NEG, g);
  h0 = carry;
  return lse;
}

// One step of a chain's max-plus (Viterbi) recurrence on its group of
// lanes, with `tgx_lse_step`'s history (h, hx, h0) and score layout:
//   cand[j] = hist[j] + s[j];  m = max_j cand[j]
//   best    = the LARGEST j with cand[j] >= m and s[j] > NEG (ties go to
//             the longest token), or none
//   value   = best ? m : NEG;  best_l = best ? best + 1 : 1
//   hist   <- [reset ? 0 : value, hist[0], ..., hist[L-2]]
// Adds and compares only, so every lane's value is the twin's bit for
// bit. The max m1 over lengths >= 2 (a butterfly) and the largest valid
// length j1 >= 2 holding it (one ballot per length tile: the highest set
// bit of the group's) read only hx, so they run a step ahead of the
// recurrence; between two steps sit the length-1 candidate c0 = h0 + s0
// and a few selects:
//   m = max(c0, m1);  best = (j1 && m1 >= c0) ? j1 : (s0 valid && c0 >=
//   m1) ? 0 : none.
// Returns the value; best_l is set on every lane.
template <int LMAX, int G, typename F>
__device__ __forceinline__ F tgx_max_step(F (&h)[LMAX / G], F (&hx)[LMAX / G],
                                          F& h0, const F (&s)[LMAX / G],
                                          typename tgx_same<F>::type s0,
                                          bool reset, int g, int L,
                                          int& best_l) {
  constexpr int P = LMAX / G;
  const F NEG = tgx_neg<F>();
  F up[P], wrap[P];
  tgx_neighbours<LMAX, G>(h, up, wrap);
  F cand[P];
  F m1 = tgx_ninf<F>();  // max over j >= 1: ready before the carry
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = g + G * p;
    cand[p] = tgx_ninf<F>();
    if (j > 0 && j < L) {
      cand[p] = hx[p] + s[p];
      m1 = tgx_max(m1, cand[p]);
    }
  }
  m1 = tgx_group_max<G>(m1);
  int j1 = -1;  // the largest valid j >= 1 with cand[j] == m1
  constexpr uint32_t gmask = G >= 32 ? TGX_FULL : (1u << (G % 32)) - 1u;
  const int base = (int)(threadIdx.x % 32) - g;  // the group's first lane
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = g + G * p;
    const bool tie = j > 0 && j < L && cand[p] >= m1 && s[p] > NEG;
    if (G == 1) {
      if (tie) j1 = p;
    } else {
      const uint32_t mine = (__ballot_sync(TGX_FULL, tie) >> base) & gmask;
      if (mine != 0u) j1 = (31 - __clz(mine)) + G * p;
    }
  }
  const F c0 = h0 + s0;
  const F m = tgx_max(c0, m1);
  const int best = (j1 >= 0 && m1 >= c0) ? j1
                   : (s0 > NEG && c0 >= m1) ? 0 : -1;
  const F v = best >= 0 ? m : NEG;
  best_l = best >= 0 ? best + 1 : 1;
  const F carry = reset ? F(0) : v;
  tgx_shift<LMAX, G>(h, up, wrap, carry, g);
  tgx_shift<LMAX, G>(hx, up, wrap, NEG, g);
  h0 = carry;
  return v;
}

// A per-length history of stream words one length on, in one call:
// h[j] <- h[j-1], h[0] <- in. The fused scans keep their prefix hashes,
// inverse powers and dropout words this way (lane j holds the word of the
// token of length j + 1), so a step loads one new word per stream and no
// lane reloads a neighbour's.
template <int LMAX, int G, typename T>
__device__ __forceinline__ void tgx_roll(T (&h)[LMAX / G], T in, int g) {
  constexpr int P = LMAX / G;
  if (G == 1) {
#pragma unroll
    for (int p = P - 1; p > 0; --p) h[p] = h[p - 1];
    h[0] = in;
    return;
  }
  T up[P], wrap[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    up[p] = __shfl_up_sync(TGX_FULL, h[p], 1, G);
    if (P > 1) wrap[p] = __shfl_sync(TGX_FULL, h[p], G - 1, G);
  }
#pragma unroll
  for (int p = 0; p < P; ++p)
    h[p] = (g > 0) ? up[p] : (p == 0 ? in : wrap[p - 1]);
}

// Lanes per chain: a lane per length up to 32 lengths, two lengths per
// lane at 64. TGX_LANES16 overrides the layout at LMAX = 16 (1, 2, 4, 8 or
// 16), so a build can time the layouts against each other
// (experiments/torch_scan_design.py); the package builds the default.
#ifndef TGX_LANES16
#define TGX_LANES16 16
#endif

// Calls LAUNCH(LMAX, G) for the LMAX that holds L lengths (8, 16, 32 or
// 64) and its layout; returns cudaErrorInvalidValue for L > 64.
#define TGX_SCAN_DISPATCH(L, LAUNCH)                                         \
  do {                                                                       \
    if ((L) <= 8) LAUNCH(8, 8);                                              \
    if ((L) <= 16) LAUNCH(16, TGX_LANES16);                                  \
    if ((L) <= 32) LAUNCH(32, 32);                                           \
    if ((L) <= 64) LAUNCH(64, 32);                                           \
    return (int)cudaErrorInvalidValue;                                       \
  } while (0)
