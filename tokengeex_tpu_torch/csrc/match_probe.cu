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
// ms at 3.35 TB/s. The table stays in the 50 MB L2, but a whole 64-byte
// bucket row (two sectors) gathered at every valid point would be ~4 GB
// from the L2 a group, and one gather waited on a length would leave the
// SMs idle: those, not device memory, are what a probe pays beyond the
// bound.
//
// What the design does about it:
//   - a miss filter in shared memory (bucket mode, where the caller passes
//     one: ops/lattice_cuda_probe.py `has_filter`, bk_bits 4-17, <= 128
//     KB): one byte a bucket row, derived from the very rows the kernel
//     reads (ops/lattice_cuda_probe.py `bucket_filter_plain`). Bit t < 7 is set when an entry of the row
//     that differs from the empty pattern (check 0, the -3e38 score) has
//     tag t = umulhi(check, 7); bit 7 when any of entries 4-7 differs from
//     it. An empty-pattern entry never hits (its score fails the test), and
//     the row comes from fp1, the tag from fp2's high bits, so a valid
//     point whose tag bit is clear is a miss and gathers nothing. No false
//     negatives: the score test stays in the gather path;
//   - one sector a gather: entries 0-3 (32 bytes) always, entries 4-7 only
//     where no entry 0-3 hit and bit 7 is set (the smallest k wins either
//     way; the build rejects a duplicate (bucket, fp2), so at most one
//     entry truly matches). That second read is rare (a row placing more
//     than four tokens), so it sits behind a warp vote, out of the line of
//     every point's code. Without the filter (the gather branch) a valid
//     point reads the whole row;
//   - persistent blocks: two 512-thread blocks an SM where the shared
//     memory holds two (the filter up to bits 16), else one of 1,024
//     threads (bits 17), each loading the filter once, then walking
//     (32-position x 32-row) tiles, positions first, a grid's stride apart
//     (so that no block meets only the costly row tiles), the next tile's
//     prefix hashes, sample ids and inverse powers staged by cp.async into
//     the second of two buffers while the block probes the current one
//     (rows at an odd stride, so that a warp's 32 lanes on 32 rows hit 32
//     banks);
//   - a warp takes a position and its lanes the 32 rows, and probes the L
//     lengths kChunk at a time, branch-free: the chunk's gathers are all
//     issued before the first is read, so a lane keeps kChunk in flight;
//     then the warp's 32 scores and slots of each length are stored as
//     coalesced runs (streaming stores, so that the cache written does not
//     push the filter rows and the table out of L2). A position where no
//     row is in a sample (a chained window's padding rows) stores misses at
//     once. Invalid points gather nothing. Output offsets are 64-bit.
// Fast mode runs on the same blocks without a filter. Exact mode (the f64
// conformance route and the prune's alternatives: windows mostly of
// padding rows, 1.4-1.9x its bound) keeps the first design: a block a
// (32-position x 32-row) tile, one launch over every tile, one exact probe
// a valid point.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tokengeex_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "fused_probe.cuh"

namespace {

constexpr int kRows = 32;       // rows a tile: a warp's lanes
constexpr int kTile = 32;       // positions a tile
constexpr int kThreads = 512;   // threads a block, two an SM
constexpr int kChunk = 2;       // lengths a lane probes with gathers in flight
constexpr int kExactWarps = 8;  // the exact mode's blocks: 256 threads

enum { TGX_BUCKET = 0, TGX_FAST = 1, TGX_EXACT = 2 };

struct ProbeArgs {
  const int32_t* p1;      // (B, p_width) prefix hashes, offset pad
  const int32_t* p2;
  const int32_t* sid;     // (B, sid_width) sample ids, -2 out of range
  const int32_t* rinv1;   // (rinv_len,) inverse powers, offset pad
  const int32_t* rinv2;
  const int32_t* t1;      // bucket rows (Hb, 16), or T1 fast (H, 2) / exact (H, 4)
  const int32_t* t2;      // T2 fast / exact rows, unused by bucket
  const void* scores;     // (V,) exact only: float, or double if scores_f64
  const int32_t* filter;  // (Hb,) bytes, the bucket filter, or null
  int32_t* slot;          // (Q, L, B) or null
  int p_width, sid_width, rinv_len;
  int B, L, Q, g0;        // Q = lead + W positions, g0 = pad - lead
  int shift;              // 32 - bits (32 - bk_bits for bucket)
  uint32_t salt;          // bucket salt
  int32_t miss;           // slot of a miss
  int32_t t2_off;         // H: T2's first slot (fast)
  int scores_f64;
  int filter_words;       // the filter's 4-byte words (Hb / 4), 0 without
  int n_qt, n_tiles;      // position tiles; tiles = n_qt x row tiles
};

// Stage words a buffer: P1, P2 and sid of kRows rows over kTile + L
// positions at the odd stride S, then the tile's rinv1 and rinv2 words.
__host__ __device__ inline int stride_of(int L) { return (kTile + L) | 1; }
__host__ __device__ inline int stage_words(int L) {
  return 3 * kRows * stride_of(L) + 2 * kTile;
}

// Shared memory of a persistent block: the filter, then two stage
// buffers.
__host__ __device__ inline size_t smem_bytes(int L, int filter_words) {
  return (size_t)filter_words * 4 + (size_t)2 * stage_words(L) * 4;
}
// The 128 KB filter of bits 17 and the stages at L = 64 take 201 KB of a
// block's 227 KB; a filter that does not fit fails the launch
// (cudaFuncSetAttribute).

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one committed group (the newest) is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start copying tile `tile`'s streams into `buf`: consecutive threads on
// consecutive positions of a row. Indices past a stream's end are clamped;
// only positions past Q read them. Rows past B are written at once
// (sample id -2: every point invalid).
template <int NT>
__device__ void stage_tile(const ProbeArgs& a, int32_t* buf, int tile) {
  const int L = a.L;
  const int n = kTile + L;
  const int S = stride_of(L);
  const int bt = tile / a.n_qt;
  const int qt = tile - bt * a.n_qt;
  const int b0 = bt * kRows;
  const int gq = a.g0 + qt * kTile;  // stream index of the tile's first
  int32_t* s_p1 = buf;
  int32_t* s_p2 = s_p1 + kRows * S;
  int32_t* s_sid = s_p2 + kRows * S;
  int32_t* s_r1 = s_sid + kRows * S;
  int32_t* s_r2 = s_r1 + kTile;
  for (int e = threadIdx.x; e < kRows * n; e += NT) {
    const int r = e / n;
    const int i = e - r * n;
    const int b = b0 + r;
    const int o = r * S + i;
    if (b < a.B) {
      const size_t gp = (size_t)b * a.p_width + min(gq + i, a.p_width - 1);
      cp_async4(s_p1 + o, a.p1 + gp);
      cp_async4(s_p2 + o, a.p2 + gp);
      cp_async4(s_sid + o,
                a.sid + (size_t)b * a.sid_width + min(gq + i, a.sid_width - 1));
    } else {
      s_p1[o] = 0;
      s_p2[o] = 0;
      s_sid[o] = -2;
    }
  }
  for (int i = threadIdx.x; i < kTile; i += NT) {
    const int g = min(gq + i, a.rinv_len - 1);
    cp_async4(s_r1 + i, a.rinv1 + g);
    cp_async4(s_r2 + i, a.rinv2 + g);
  }
}

// The entry k < 4 of two int4 (entries 0-1, 2-3) that hits fp2, the
// smallest one, or -1; its score in `sk`.
__device__ __forceinline__ int match4(const int4& w0, const int4& w1,
                                      uint32_t fp2, float& sk) {
  int hit = -1;
  // Descending, so that the first matching entry wins.
#pragma unroll
  for (int k = 3; k >= 0; --k) {
    const int4& v = k < 2 ? w0 : w1;
    const uint32_t chk = (uint32_t)((k & 1) ? v.z : v.x);
    const float s = __int_as_float((k & 1) ? v.w : v.y);
    if (chk == fp2 && s > -1.0e38f) {
      hit = k;
      sk = s;
    }
  }
  return hit;
}

// One point of a chunk, branch-free: `issue` computes its table rows and
// starts their gathers where it is live (a point that gathers nothing is a
// miss); `first` reads them and says whether the point still needs a
// bucket row's second sector; `second` reads that (rare: a row placing an
// entry past 3); `result` gives the score and the slot.
template <int MODE, bool FILTER>
struct Point;

template <bool FILTER>
struct Point<TGX_BUCKET, FILTER> {
  uint32_t row, fp2;
  bool live, over, full;
  int k;
  float sk;
  int4 w0, w1, w2, w3;  // w2, w3: the second sector

  __device__ __forceinline__ void issue(const ProbeArgs& a,
                                        const uint8_t* s_filter,
                                        uint32_t fp1, uint32_t fp2_,
                                        uint32_t l, bool valid) {
    fp2 = fp2_;
    row = ((fp1 ^ (l * TGX_IDX_A1) ^ a.salt) * TGX_IDX_M1) >> a.shift;
    live = valid;
    over = true;
    if constexpr (FILTER) {
      const uint32_t f = valid ? s_filter[row] : 0u;
      live = (f >> __umulhi(fp2, 7u)) & 1u;
      over = f >> 7;
    }
    const int4* r = reinterpret_cast<const int4*>(a.t1) + (size_t)row * 4;
    if (live) {
      w0 = __ldg(r);
      w1 = __ldg(r + 1);
      if constexpr (!FILTER) {
        w2 = __ldg(r + 2);
        w3 = __ldg(r + 3);
      }
    }
  }

  // The smallest entry 0-3 whose check is fp2 hits when its score is
  // live. One whose score is dead (a removed token) may hide a live
  // duplicate behind it: such a point, like a miss in a row placing entries
  // past 3, takes the full match in `second`.
  __device__ __forceinline__ bool first() {
    sk = -INFINITY;
    k = -1;
    full = false;
    if constexpr (!FILTER) {  // the gather branch: the whole row is here
      if (live) {
        k = match4(w0, w1, fp2, sk);
        if (k < 0) {
          k = match4(w2, w3, fp2, sk);
          if (k >= 0) k += 4;
        }
      }
      return false;
    }
    const bool c0 = (uint32_t)w0.x == fp2, c1 = (uint32_t)w0.z == fp2;
    const bool c2 = (uint32_t)w1.x == fp2, c3 = (uint32_t)w1.z == fp2;
    const int kc = c0 ? 0 : c1 ? 1 : c2 ? 2 : c3 ? 3 : -1;
    const float s = __int_as_float(c0 ? w0.y : c1 ? w0.w : c2 ? w1.y : w1.w);
    const bool ok = live && kc >= 0 && s > -1.0e38f;
    if (ok) {
      k = kc;
      sk = s;
    }
    full = live && kc >= 0 && !ok;
    return live && !ok && (over || full);
  }

  __device__ __forceinline__ void second(const ProbeArgs& a) {
    if (!(live && k < 0 && (over || full))) return;
    k = match4(w0, w1, fp2, sk);
    if (k >= 0 || !over) return;
    if constexpr (FILTER) {
      const int4* r = reinterpret_cast<const int4*>(a.t1) + (size_t)row * 4;
      w2 = __ldg(r + 2);
      w3 = __ldg(r + 3);
    }
    k = match4(w2, w3, fp2, sk);
    if (k >= 0) k += 4;
  }

  template <typename T>
  __device__ __forceinline__ void result(const ProbeArgs& a, T& score,
                                         int32_t& slot) const {
    score = static_cast<T>(sk);
    slot = k >= 0 ? (int32_t)(row * 8u + (uint32_t)k) : a.miss;
  }
};

template <bool FILTER>
struct Point<TGX_FAST, FILTER> {
  uint32_t chk, i1, i2;
  bool live;
  int2 r1, r2;

  __device__ __forceinline__ void issue(const ProbeArgs& a, const uint8_t*,
                                        uint32_t fp1, uint32_t fp2,
                                        uint32_t l, bool valid) {
    chk = tgx_check(fp1, fp2);
    i1 = tgx_slot1(fp1, l, a.shift);
    i2 = tgx_slot2(fp2, l, a.shift);
    live = valid;
    if (live) {
      r1 = __ldg(reinterpret_cast<const int2*>(a.t1) + i1);
      r2 = __ldg(reinterpret_cast<const int2*>(a.t2) + i2);
    }
  }

  __device__ __forceinline__ bool first() { return false; }
  __device__ __forceinline__ void second(const ProbeArgs&) {}

  template <typename T>
  __device__ __forceinline__ void result(const ProbeArgs& a, T& score,
                                         int32_t& slot) const {
    const float s1 = __int_as_float(r1.y);
    const float s2 = __int_as_float(r2.y);
    const bool h1 = live && (uint32_t)r1.x == chk && s1 > -1.0e38f;
    const bool h2 = live && (uint32_t)r2.x == chk && s2 > -1.0e38f;
    score = static_cast<T>(h1 ? s1 : h2 ? s2 : -INFINITY);
    slot = h1 ? (int32_t)i1 : h2 ? (int32_t)i2 + a.t2_off : a.miss;
  }
};

// Probe the staged tile: a warp a position, its lanes the rows. A position
// where no lane's row is in a sample stores misses at once.
template <int NT, int MODE, bool FILTER, bool SLOTS, typename T>
__device__ __forceinline__ void probe_tile(const ProbeArgs& a,
                                           const uint8_t* s_filter,
                                           const int32_t* buf, int tile,
                                           T* __restrict__ score) {
  const int L = a.L;
  const int S = stride_of(L);
  const int bt = tile / a.n_qt;
  const int q0 = (tile - bt * a.n_qt) * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = bt * kRows + lane;
  const bool row_ok = b < a.B;
  const int32_t* r_p1 = buf + lane * S;
  const int32_t* r_p2 = r_p1 + kRows * S;
  const int32_t* r_sid = r_p2 + kRows * S;
  const int32_t* s_r1 = buf + 3 * kRows * S;
  const int32_t* s_r2 = s_r1 + kTile;
  for (int qi = warp; qi < kTile; qi += NT / 32) {
    const int q = q0 + qi;
    if (q >= a.Q) break;
    const int32_t sid0 = r_sid[qi];
    T* out = score + (size_t)q * L * a.B + b;
    int32_t* out_slot = SLOTS ? a.slot + (size_t)q * L * a.B + b : nullptr;
    if (!__any_sync(0xffffffffu, sid0 >= 0)) {
      if (row_ok) {
        for (int j = 0; j < L; ++j) {
          __stcs(out + (size_t)j * a.B, static_cast<T>(-INFINITY));
          if constexpr (SLOTS) __stcs(out_slot + (size_t)j * a.B, a.miss);
        }
      }
      continue;
    }
    const uint32_t base1 = (uint32_t)r_p1[qi];
    const uint32_t base2 = (uint32_t)r_p2[qi];
    const uint32_t ri1 = (uint32_t)s_r1[qi];
    const uint32_t ri2 = (uint32_t)s_r2[qi];
    for (int j0 = 0; j0 < L; j0 += kChunk) {
      Point<MODE, FILTER> pt[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = min(j0 + c, L - 1);  // a length past L: a miss, unstored
        const uint32_t fp1 = ((uint32_t)r_p1[qi + j + 1] - base1) * ri1;
        const uint32_t fp2 = ((uint32_t)r_p2[qi + j + 1] - base2) * ri2;
        const bool valid =
            j0 + c < L && sid0 >= 0 && r_sid[qi + j] == sid0;
        pt[c].issue(a, s_filter, fp1, fp2, (uint32_t)(j + 1), valid);
      }
      if constexpr (MODE == TGX_BUCKET) {
        bool need = false;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) need |= pt[c].first();
        if (FILTER && __any_sync(0xffffffffu, need)) {
#pragma unroll
          for (int c = 0; c < kChunk; ++c) pt[c].second(a);
        }
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        if (j >= L) break;
        T s;
        int32_t sl;
        pt[c].result(a, s, sl);
        if (row_ok) {
          __stcs(out + (size_t)j * a.B, s);
          if constexpr (SLOTS) __stcs(out_slot + (size_t)j * a.B, sl);
        }
      }
    }
  }
}

// NT threads a block, 1024 / NT blocks an SM allowed by the registers (64
// a thread).
template <int NT, int MODE, bool FILTER, bool SLOTS, typename T>
__global__ void __launch_bounds__(NT, 1024 / NT)
match_probe_kernel(const ProbeArgs a, T* __restrict__ score) {
  extern __shared__ __align__(16) int32_t smem[];
  const uint8_t* s_filter = reinterpret_cast<const uint8_t*>(smem);
  int32_t* stages = smem + (FILTER ? a.filter_words : 0);
  const int words = stage_words(a.L);
  int tile = blockIdx.x;
  if (tile >= a.n_tiles) return;
  if constexpr (FILTER) {
    for (int i = threadIdx.x; i < a.filter_words / 4; i += NT)
      cp_async16(smem + 4 * i, a.filter + 4 * i);
  }
  stage_tile<NT>(a, stages, tile);
  cp_async_commit();
  for (int k = 0; tile < a.n_tiles; tile += gridDim.x, ++k) {
    const int next = tile + gridDim.x;
    if (next < a.n_tiles)
      stage_tile<NT>(a, stages + ((k + 1) & 1) * words, next);
    cp_async_commit();  // possibly empty: the wait below counts groups
    cp_async_wait_one();
    __syncthreads();
    probe_tile<NT, MODE, FILTER, SLOTS, T>(a, s_filter,
                                           stages + (k & 1) * words, tile,
                                           score);
    __syncthreads();  // the buffer is restaged two tiles on
  }
}

// The exact mode, the first design's kernel: a block a (32-position x
// 32-row) tile, one launch over every tile. The block stages its rows' P1,
// P2 and sid and its rinv words, then each warp takes a position and its
// lanes the rows, and walks the L lengths, one exact probe a valid point:
// T1's and T2's rows, the id of the one that holds both fingerprints and
// the length (T1 first), the score by id. At float scores its registers
// are held to 32, eight blocks an SM, as the first design's build had them.
template <bool SLOTS, typename T>
__global__ void __launch_bounds__(32 * kExactWarps, sizeof(T) == 4 ? 8 : 1)
exact_probe_kernel(const ProbeArgs a, T* __restrict__ score) {
  extern __shared__ __align__(16) int32_t smem[];
  const int L = a.L;
  const int n = kTile + L;
  const int S = stride_of(L);
  int32_t* s_p1 = smem;
  int32_t* s_p2 = s_p1 + kRows * S;
  int32_t* s_sid = s_p2 + kRows * S;
  int32_t* s_r1 = s_sid + kRows * S;
  int32_t* s_r2 = s_r1 + kTile;
  const int q0 = blockIdx.x * kTile;
  const int b0 = blockIdx.y * kRows;
  const int gq = a.g0 + q0;
  for (int e = threadIdx.x; e < kRows * n; e += blockDim.x) {
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
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
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
  for (int qi = warp; qi < kTile; qi += kExactWarps) {
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
      const uint32_t l = (uint32_t)(j + 1);
      T s = static_cast<T>(-INFINITY);
      int32_t id = -1;
      if (sid0 >= 0 && r_sid[qi + j] == sid0) {
        const int4 e1 = __ldg(reinterpret_cast<const int4*>(a.t1) +
                              tgx_slot1(fp1, l, a.shift));
        const int4 e2 = __ldg(reinterpret_cast<const int4*>(a.t2) +
                              tgx_slot2(fp2, l, a.shift));
        if ((uint32_t)e2.x == fp1 && (uint32_t)e2.y == fp2 &&
            ((uint32_t)e2.z >> 24) == l)
          id = e2.z & 0xFFFFFF;
        if ((uint32_t)e1.x == fp1 && (uint32_t)e1.y == fp2 &&
            ((uint32_t)e1.z >> 24) == l)
          id = e1.z & 0xFFFFFF;
        if (id >= 0)
          s = a.scores_f64
                  ? static_cast<T>(__ldg(static_cast<const double*>(a.scores) + id))
                  : static_cast<T>(__ldg(static_cast<const float*>(a.scores) + id));
      }
      if (row_ok) {
        const size_t o = out + (size_t)j * a.B;
        __stcs(score + o, s);
        if constexpr (SLOTS) __stcs(a.slot + o, id);
      }
    }
  }
}

constexpr int kTooFew = -1;  // not a CUDA error code

// Persistent blocks of NT threads, as many as fit on the SMs; kTooFew, and
// no launch, where fewer than `least` fit an SM.
template <int NT, int MODE, bool FILTER, bool SLOTS, typename T>
int launch_blocks(const ProbeArgs& a, T* score, size_t smem, int least,
                  cudaStream_t stream) {
  auto kernel = match_probe_kernel<NT, MODE, FILTER, SLOTS, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < least) return kTooFew;
  kernel<<<std::min(a.n_tiles, sms * per_sm), NT, smem, stream>>>(a, score);
  return (int)cudaGetLastError();
}

// Two 512-thread blocks an SM where its shared memory holds two (every
// table without the filter; the filter up to 64 KB), else one block of
// 1,024 threads (the 128 KB filter of bits 17).
template <int MODE, bool FILTER, bool SLOTS, typename T>
int launch_mode(const ProbeArgs& a, T* score, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.L, FILTER ? a.filter_words : 0);
  if constexpr (FILTER) {
    const int rc =
        launch_blocks<kThreads, MODE, FILTER, SLOTS, T>(a, score, smem, 2,
                                                        stream);
    if (rc != kTooFew) return rc;
    const int one = launch_blocks<2 * kThreads, MODE, FILTER, SLOTS, T>(
        a, score, smem, 1, stream);
    return one == kTooFew ? (int)cudaErrorInvalidConfiguration : one;
  } else {
    const int rc =
        launch_blocks<kThreads, MODE, FILTER, SLOTS, T>(a, score, smem, 1,
                                                        stream);
    return rc == kTooFew ? (int)cudaErrorInvalidConfiguration : rc;
  }
}

template <bool SLOTS, typename T>
int launch_exact(const ProbeArgs& a, T* score, cudaStream_t stream) {
  const dim3 grid(a.n_qt, a.n_tiles / a.n_qt);
  exact_probe_kernel<SLOTS, T>
      <<<grid, 32 * kExactWarps, stage_words(a.L) * sizeof(int32_t),
         stream>>>(a, score);
  return (int)cudaGetLastError();
}

template <int MODE, typename T>
int launch_slots(const ProbeArgs& a, T* score, cudaStream_t s) {
  const bool slots = a.slot != nullptr;
  if constexpr (MODE == TGX_EXACT) {
    return slots ? launch_exact<true>(a, score, s)
                 : launch_exact<false>(a, score, s);
  } else {
    if (MODE == TGX_BUCKET && a.filter != nullptr)
      return slots ? launch_mode<MODE, MODE == TGX_BUCKET, true>(a, score, s)
                   : launch_mode<MODE, MODE == TGX_BUCKET, false>(a, score,
                                                                  s);
    return slots ? launch_mode<MODE, false, true>(a, score, s)
                 : launch_mode<MODE, false, false>(a, score, s);
  }
}

template <typename T>
int probe(const int32_t* p1, const int32_t* p2, const int32_t* sid,
          const int32_t* rinv1, const int32_t* rinv2, const int32_t* t1,
          const int32_t* t2, const void* scores, const void* filter,
          T* score, int32_t* slot, int p_width, int sid_width, int rinv_len,
          int B, int L, int Q, int g0, int mode, int shift, unsigned salt,
          int miss, int t2_off, int scores_f64, void* stream) {
  // The filter is a bucket table's, copied 16 bytes at a time.
  if (B < 1 || Q < 1 || L < 1 || L > 64 || g0 < 0 || shift < 1 ||
      shift > 31 || mode < TGX_BUCKET || mode > TGX_EXACT ||
      (mode == TGX_EXACT && scores == nullptr) ||
      (mode != TGX_BUCKET && t2 == nullptr) ||
      (filter != nullptr && (mode != TGX_BUCKET || 32 - shift < 4)) ||
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
  a.filter = static_cast<const int32_t*>(filter);
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
  a.filter_words = filter != nullptr ? (1 << (32 - shift)) / 4 : 0;
  a.n_qt = (Q + kTile - 1) / kTile;
  const long long tiles = (long long)a.n_qt * ((B + kRows - 1) / kRows);
  if (tiles > (1ll << 31) - 1) return (int)cudaErrorInvalidValue;
  a.n_tiles = (int)tiles;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case TGX_BUCKET:
      return launch_slots<TGX_BUCKET>(a, score, s);
    case TGX_FAST:
      return launch_slots<TGX_FAST>(a, score, s);
    default:
      return launch_slots<TGX_EXACT>(a, score, s);
  }
}

}  // namespace

// The probe with float scores. mode: 0 bucket, 1 fast, 2 exact; slot may
// be null (scores only); scores (exact only) are float, or double when
// scores_f64; filter (bucket only, bk_bits >= 4, 16-byte aligned) is the
// table's miss filter, or null for the gather branch. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int tgx_match_probe(const int32_t* p1, const int32_t* p2,
                               const int32_t* sid, const int32_t* rinv1,
                               const int32_t* rinv2, const int32_t* t1,
                               const int32_t* t2, const void* scores,
                               const void* filter, float* score,
                               int32_t* slot, int p_width, int sid_width,
                               int rinv_len, int B, int L, int Q, int g0,
                               int mode, int shift, unsigned salt, int miss,
                               int t2_off, int scores_f64, void* stream) {
  return probe<float>(p1, p2, sid, rinv1, rinv2, t1, t2, scores, filter,
                      score, slot, p_width, sid_width, rinv_len, B, L, Q, g0,
                      mode, shift, salt, miss, t2_off, scores_f64, stream);
}

// The same probe with double scores (the f64 / exact conformance route).
extern "C" int tgx_match_probe_f64(const int32_t* p1, const int32_t* p2,
                                   const int32_t* sid, const int32_t* rinv1,
                                   const int32_t* rinv2, const int32_t* t1,
                                   const int32_t* t2, const void* scores,
                                   const void* filter, double* score,
                                   int32_t* slot, int p_width, int sid_width,
                                   int rinv_len, int B, int L, int Q, int g0,
                                   int mode, int shift, unsigned salt,
                                   int miss, int t2_off, int scores_f64,
                                   void* stream) {
  return probe<double>(p1, p2, sid, rinv1, rinv2, t1, t2, scores, filter,
                       score, slot, p_width, sid_width, rinv_len, B, L, Q,
                       g0, mode, shift, salt, miss, t2_off, scores_f64,
                       stream);
}
