// The first design of tokengeex_tpu_torch/csrc/match_probe.cu (a block a
// 32-position x 32-row tile, one launch over every tile, each valid point
// gathering its whole table row: 64 bytes, two sectors, a bucket), kept
// with its C interface for experiments/torch_probe_design.py, which times
// it beside the package's kernel in one process. Not built by the package.
//
// The slab route's vocabulary probe, one launch a row group, for Hopper
// (sm_90a).
//
// Replaces: tokengeex_tpu/ops/lattice_jax.py `_match_slab` as
// `_match_cache_impl` drives it (an XLA program, no Pallas kernel); in the
// port, the torch ops of ops/lattice.py `match_cache_plain`, its twin.
//
// What it computes, per row b, start position p in [-lead, W) and token
// length l = j + 1 <= L, at q = lead + p and g = pad + p:
//   fp1 = (P1[b, g + l] - P1[b, g]) * rinv1[g]   (uint32 wrap; fp2 alike)
//   valid = sid[b, g] >= 0 && sid[b, g + j] == sid[b, g]
// and writes score[q, j, b] (and slot[q, j, b] when slots are asked for),
// the start-indexed (lead + W, L, B) cache the scans read. An invalid
// point is a miss. The cache holds no dropout: its readers draw the coins.
//   - bucket: the 64-byte row ((fp1 ^ l*A1 ^ salt) * M1) >>> (32 - bk_bits)
//     of 8 interleaved [check, score] entries; the first entry k with check
//     == fp2 and score > -1e38 hits, slot = row * 8 + k;
//   - fast: rows [check, score] of T1 and T2 (slots tgx_slot1 / tgx_slot2,
//     check word tgx_check); a row hits when its check matches and its
//     score is above -1e38 (so an empty T1 row never does), T1 first; slot
//     = idx1, or H + idx2;
//   - exact: rows [fp1, fp2, len << 24 | id, 0] of T1 and T2; a row hits
//     when it holds both fingerprints and the length, T1 first; the slot is
//     the id (the low 24 bits), the score scores[id] at the tables' type
//     (float or double) cast to the output type.
// A miss scores -inf and takes the slot `miss` (num_slots, bk_num_slots, or
// -1 for exact). The float comparisons and casts are the twin's, so score
// and slot are bit-equal to it.
//
// What bounds it on the H100: bytes. A (position, length, row) point reads
// 12 bytes a position of stream (the prefix hashes and the sample id, read
// once for all L lengths) and writes 4 (or 8) bytes of score and 4 of slot:
// the 8192 x 16 x 512 group of encode (a) writes 268 MB of scores, 0.080
// ms at 3.35 TB/s. Each valid point also gathers a table row (64 bytes a
// bucket, 8 or 16 a cuckoo row) from a table that stays in the 50 MB L2
// (4 MB for the 32k vocabulary's buckets); those gathers, not device
// memory, are what the simple design below pays for beyond the bound.
//
// What the design does about it: one block per (32 positions x 32 rows)
// tile. The block stages its rows' P1, P2 and sid over the tile's positions
// plus L into shared memory with loads along the positions (row stride odd,
// so that 32 lanes on 32 rows hit 32 banks) and the tile's rinv words; then
// each warp takes a position and its lanes the 32 rows, and walks the L
// lengths: a lane computes its point from shared memory, gathers one row
// per table (an int4 per 16 bytes), and the warp's 32 scores and slots are
// stored as coalesced runs (streaming stores, so that the cache written
// does not push the table out of L2). Invalid points gather nothing. Output
// offsets are 64-bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tokengeex_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fused_probe.cuh"

#define TGX_PROBE_ROWS 32   // rows a block: a warp's lanes
#define TGX_PROBE_TILE 32   // positions a block
#define TGX_PROBE_WARPS 8   // warps a block

enum { TGX_BUCKET = 0, TGX_FAST = 1, TGX_EXACT = 2 };

struct ProbeArgs {
  const int32_t* p1;     // (B, p_width) prefix hashes, offset pad
  const int32_t* p2;
  const int32_t* sid;    // (B, sid_width) sample ids, -2 out of range
  const int32_t* rinv1;  // (rinv_len,) inverse powers, offset pad
  const int32_t* rinv2;
  const int32_t* t1;     // bucket rows (Hb, 16), or T1 fast (H, 2) / exact (H, 4)
  const int32_t* t2;     // T2 fast / exact rows, unused by bucket
  const void* scores;    // (V,) exact only: float, or double if scores_f64
  int32_t* slot;         // (Q, L, B) or null
  int p_width, sid_width, rinv_len;
  int B, L, Q, g0;       // Q = lead + W positions, g0 = pad - lead
  int shift;             // 32 - bits (32 - bk_bits for bucket)
  uint32_t salt;         // bucket salt
  int32_t miss;          // slot of a miss
  int32_t t2_off;        // H: T2's first slot (fast)
  int scores_f64;
};

// One point's (score, slot) from its fingerprints; `valid` false is a miss.
template <int MODE, typename T>
__device__ __forceinline__ void probe_point(const ProbeArgs& a, uint32_t fp1,
                                            uint32_t fp2, uint32_t l,
                                            bool valid, T& score,
                                            int32_t& slot) {
  score = static_cast<T>(-INFINITY);
  slot = a.miss;
  if (!valid) return;
  if constexpr (MODE == TGX_BUCKET) {
    const uint32_t row = ((fp1 ^ (l * TGX_IDX_A1) ^ a.salt) * TGX_IDX_M1)
                         >> a.shift;
    const int4* r = reinterpret_cast<const int4*>(a.t1) + (size_t)row * 4;
    int4 w[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c] = __ldg(r + c);
    // Descending, so that the first matching entry wins.
#pragma unroll
    for (int k = 7; k >= 0; --k) {
      const int4& v = w[k >> 1];
      const uint32_t chk = (uint32_t)((k & 1) ? v.z : v.x);
      const float sk = __int_as_float((k & 1) ? v.w : v.y);
      if (chk == fp2 && sk > -1.0e38f) {
        score = static_cast<T>(sk);
        slot = (int32_t)(row * 8u + (uint32_t)k);
      }
    }
  } else if constexpr (MODE == TGX_FAST) {
    const uint32_t chk = tgx_check(fp1, fp2);
    const uint32_t i1 = tgx_slot1(fp1, l, a.shift);
    const uint32_t i2 = tgx_slot2(fp2, l, a.shift);
    const int2 r1 = __ldg(reinterpret_cast<const int2*>(a.t1) + i1);
    const int2 r2 = __ldg(reinterpret_cast<const int2*>(a.t2) + i2);
    const float s1 = __int_as_float(r1.y);
    const float s2 = __int_as_float(r2.y);
    if ((uint32_t)r1.x == chk && s1 > -1.0e38f) {
      score = static_cast<T>(s1);
      slot = (int32_t)i1;
    } else if ((uint32_t)r2.x == chk && s2 > -1.0e38f) {
      score = static_cast<T>(s2);
      slot = (int32_t)i2 + a.t2_off;
    }
  } else {
    const uint32_t i1 = tgx_slot1(fp1, l, a.shift);
    const uint32_t i2 = tgx_slot2(fp2, l, a.shift);
    const int4 e1 = __ldg(reinterpret_cast<const int4*>(a.t1) + i1);
    const int4 e2 = __ldg(reinterpret_cast<const int4*>(a.t2) + i2);
    int32_t id = -1;
    if ((uint32_t)e2.x == fp1 && (uint32_t)e2.y == fp2 &&
        ((uint32_t)e2.z >> 24) == l)
      id = e2.z & 0xFFFFFF;
    if ((uint32_t)e1.x == fp1 && (uint32_t)e1.y == fp2 &&
        ((uint32_t)e1.z >> 24) == l)
      id = e1.z & 0xFFFFFF;
    if (id >= 0) {
      score = a.scores_f64
                  ? static_cast<T>(__ldg(static_cast<const double*>(a.scores) + id))
                  : static_cast<T>(__ldg(static_cast<const float*>(a.scores) + id));
    }
    slot = id;
  }
}

template <int MODE, bool SLOTS, typename T>
__global__ void __launch_bounds__(32 * TGX_PROBE_WARPS)
match_probe_kernel(const ProbeArgs a, T* __restrict__ score) {
  extern __shared__ int32_t smem[];
  const int L = a.L;
  const int n = TGX_PROBE_TILE + L;  // staged positions a row
  const int S = n | 1;               // odd row stride: no bank conflicts
  int32_t* s_p1 = smem;
  int32_t* s_p2 = s_p1 + TGX_PROBE_ROWS * S;
  int32_t* s_sid = s_p2 + TGX_PROBE_ROWS * S;
  int32_t* s_r1 = s_sid + TGX_PROBE_ROWS * S;
  int32_t* s_r2 = s_r1 + TGX_PROBE_TILE;

  const int q0 = blockIdx.x * TGX_PROBE_TILE;
  const int b0 = blockIdx.y * TGX_PROBE_ROWS;
  const int gq = a.g0 + q0;  // stream index of the tile's first position

  // Stage: consecutive threads on consecutive positions of a row. Indices
  // past a stream's end are clamped; only positions past Q read them.
  for (int e = threadIdx.x; e < TGX_PROBE_ROWS * n; e += blockDim.x) {
    const int r = e / n;
    const int i = e - r * n;
    const int b = b0 + r;
    int32_t v1 = 0, v2 = 0, vs = -2;
    if (b < a.B) {
      const size_t gp = (size_t)b * a.p_width + min(gq + i, a.p_width - 1);
      v1 = a.p1[gp];
      v2 = a.p2[gp];
      vs = a.sid[(size_t)b * a.sid_width + min(gq + i, a.sid_width - 1)];
    }
    s_p1[r * S + i] = v1;
    s_p2[r * S + i] = v2;
    s_sid[r * S + i] = vs;
  }
  for (int i = threadIdx.x; i < TGX_PROBE_TILE; i += blockDim.x) {
    const int g = min(gq + i, a.rinv_len - 1);
    s_r1[i] = a.rinv1[g];
    s_r2[i] = a.rinv2[g];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = b0 + lane;
  const bool row_ok = b < a.B;
  const int32_t* r_p1 = s_p1 + lane * S;
  const int32_t* r_p2 = s_p2 + lane * S;
  const int32_t* r_sid = s_sid + lane * S;
  for (int qi = warp; qi < TGX_PROBE_TILE; qi += TGX_PROBE_WARPS) {
    const int q = q0 + qi;
    if (q >= a.Q) break;
    const uint32_t base1 = (uint32_t)r_p1[qi];
    const uint32_t base2 = (uint32_t)r_p2[qi];
    const int32_t sid0 = r_sid[qi];
    const uint32_t ri1 = (uint32_t)s_r1[qi];
    const uint32_t ri2 = (uint32_t)s_r2[qi];
    const size_t out = (size_t)q * L * a.B + b;
#pragma unroll 4
    for (int j = 0; j < L; ++j) {
      const uint32_t fp1 = ((uint32_t)r_p1[qi + j + 1] - base1) * ri1;
      const uint32_t fp2 = ((uint32_t)r_p2[qi + j + 1] - base2) * ri2;
      const bool valid = sid0 >= 0 && r_sid[qi + j] == sid0;
      T s;
      int32_t sl;
      probe_point<MODE, T>(a, fp1, fp2, (uint32_t)(j + 1), valid, s, sl);
      if (row_ok) {
        const size_t o = out + (size_t)j * a.B;
        __stcs(score + o, s);
        if constexpr (SLOTS) __stcs(a.slot + o, sl);
      }
    }
  }
}

template <int MODE, bool SLOTS, typename T>
static int launch_mode(const ProbeArgs& a, T* score, cudaStream_t stream) {
  const dim3 grid((a.Q + TGX_PROBE_TILE - 1) / TGX_PROBE_TILE,
                  (a.B + TGX_PROBE_ROWS - 1) / TGX_PROBE_ROWS);
  const int S = (TGX_PROBE_TILE + a.L) | 1;
  const size_t smem =
      (3 * (size_t)TGX_PROBE_ROWS * S + 2 * TGX_PROBE_TILE) * sizeof(int32_t);
  match_probe_kernel<MODE, SLOTS, T>
      <<<grid, 32 * TGX_PROBE_WARPS, smem, stream>>>(a, score);
  return (int)cudaGetLastError();
}

template <typename T>
static int probe(const int32_t* p1, const int32_t* p2, const int32_t* sid,
                 const int32_t* rinv1, const int32_t* rinv2,
                 const int32_t* t1, const int32_t* t2, const void* scores,
                 T* score, int32_t* slot, int p_width, int sid_width,
                 int rinv_len, int B, int L, int Q, int g0, int mode,
                 int shift, unsigned salt, int miss, int t2_off,
                 int scores_f64, void* stream) {
  // L <= 64 keeps the staging under the 48 KB of static shared memory.
  if (B < 1 || Q < 1 || L < 1 || L > 64 || g0 < 0 || shift < 1 ||
      shift > 31 || mode < TGX_BUCKET || mode > TGX_EXACT ||
      (mode == TGX_EXACT && scores == nullptr) ||
      (mode != TGX_BUCKET && t2 == nullptr) ||
      (long long)Q * L * B >= (1ll << 62))
    return (int)cudaErrorInvalidValue;
  ProbeArgs a = {};
  a.p1 = p1;
  a.p2 = p2;
  a.sid = sid;
  a.rinv1 = rinv1;
  a.rinv2 = rinv2;
  a.t1 = t1;
  a.t2 = t2;
  a.scores = scores;
  a.slot = slot;
  a.p_width = p_width;
  a.sid_width = sid_width;
  a.rinv_len = rinv_len;
  a.B = B;
  a.L = L;
  a.Q = Q;
  a.g0 = g0;
  a.shift = shift;
  a.salt = salt;
  a.miss = miss;
  a.t2_off = t2_off;
  a.scores_f64 = scores_f64;
  cudaStream_t s = (cudaStream_t)stream;
  const bool slots = slot != nullptr;
  switch (mode) {
    case TGX_BUCKET:
      return slots ? launch_mode<TGX_BUCKET, true>(a, score, s)
                   : launch_mode<TGX_BUCKET, false>(a, score, s);
    case TGX_FAST:
      return slots ? launch_mode<TGX_FAST, true>(a, score, s)
                   : launch_mode<TGX_FAST, false>(a, score, s);
    default:
      return slots ? launch_mode<TGX_EXACT, true>(a, score, s)
                   : launch_mode<TGX_EXACT, false>(a, score, s);
  }
}

// The probe with float scores. mode: 0 bucket, 1 fast, 2 exact; slot may
// be null (scores only); scores (exact only) are float, or double when
// scores_f64. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tgx_match_probe(const int32_t* p1, const int32_t* p2,
                               const int32_t* sid, const int32_t* rinv1,
                               const int32_t* rinv2, const int32_t* t1,
                               const int32_t* t2, const void* scores,
                               float* score, int32_t* slot, int p_width,
                               int sid_width, int rinv_len, int B, int L,
                               int Q, int g0, int mode, int shift,
                               unsigned salt, int miss, int t2_off,
                               int scores_f64, void* stream) {
  return probe<float>(p1, p2, sid, rinv1, rinv2, t1, t2, scores, score, slot,
                      p_width, sid_width, rinv_len, B, L, Q, g0, mode, shift,
                      salt, miss, t2_off, scores_f64, stream);
}

// The same probe with double scores (the f64 / exact conformance route).
extern "C" int tgx_match_probe_f64(const int32_t* p1, const int32_t* p2,
                                   const int32_t* sid, const int32_t* rinv1,
                                   const int32_t* rinv2, const int32_t* t1,
                                   const int32_t* t2, const void* scores,
                                   double* score, int32_t* slot, int p_width,
                                   int sid_width, int rinv_len, int B, int L,
                                   int Q, int g0, int mode, int shift,
                                   unsigned salt, int miss, int t2_off,
                                   int scores_f64, void* stream) {
  return probe<double>(p1, p2, sid, rinv1, rinv2, t1, t2, scores, score,
                       slot, p_width, sid_width, rinv_len, B, L, Q, g0, mode,
                       shift, salt, miss, t2_off, scores_f64, stream);
}
