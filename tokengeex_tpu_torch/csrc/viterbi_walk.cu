// Viterbi backpointer walk with the exact-probe id lookup, for Hopper
// (sm_90a): a segment-parallel walk.
//
// Replaces: tokengeex_tpu/ops/lattice_jax.py `_viterbi_freq_impl` (an XLA
// program: a descending scan over the backpointers, two exact-table row
// gathers per on-path position, an int32 scatter-add), entered through
// `viterbi_freq`; and, for encode, the threaded native backtrack the JAX
// package calls there (`_native_flat_backtrack`).
//
// What it computes, per span (row, s, e) of whole, non-empty, reachable
// samples: from q = e, step back q <- q - best_l[q - 1] (a 0 steps by 1)
// while q > s; each step is the token [q - l, q). Its id comes from the
// exact tables:
//   fp  = (P[q] - P[q - l]) * Rinv[q - l]        (both hash streams, mod 2^32)
//   i1  = ((fp1 ^ l * IDX_A1) * IDX_M1) >>> (32 - bits), i2 the same on fp2
//   id  = T1[i1] when its fp1, fp2 and length (word 2 >>> 24) all match,
//         else T2[i2] when they match there, else V (no token: a mismatch).
// Three modes of one body:
//   - count (V + 1,) int32: every token adds one to its id's bin (bin V
//     counts mismatches); integer atomics, so the counts are exact;
//   - ntok (n,): the tokens of each span (the first of ids mode's two
//     launches; the caller turns them into offsets with one cumsum);
//   - ids: the spans' ids written into one flat int32 buffer, span after
//     span in the caller's order: span k's ids, in position order, at
//     [incl[k] - ntok[k], incl[k]), incl the inclusive cumsum of ntok.
// A span whose `ok` flag is 0 (unreachable end) is not walked (ntok 0).
//
// What bounds it on the H100: first latency, a walk being a chain of
// dependent loads (~2-3 k per 8 KB sample); once the chains are cut
// short, the id lookups (two random 16-byte row gathers and the prefix-
// hash words of every token, ~60-80 MB a row group) and count mode's
// atomics on hot ids.
//
// What the design does about it: one block per row, the row's
// backpointers (W bytes) staged in shared memory, and no thread walks a
// whole span. A backpointer reaches back at most L positions, so a walk
// entering the segment (a, a + S] of S >= 2L positions from above lands
// first on one of its top L nodes a + S - t, t in [0, L):
//   (a) every (segment, entry t) walks, speculatively, down to its first
//       node <= a, and records the exit offset (a - node, in [0, L)) and
//       its tokens: (W / S) * L independent chains of ~S / 3.5 steps, two
//       a thread at once;
//   (b) one thread per span composes: from e it walks e's own segment,
//       then follows the exit table one segment per lookup, and walks the
//       segment holding s down to s; each whole segment a span crosses is
//       recorded with its real entry and the span's tokens before it (a
//       whole segment lies inside one span, since spans are disjoint);
//   (c) one thread per recorded segment walks it again from its real
//       entry; a block scan lists the recorded tokens densely, and the
//       block resolves their ids TGX_WALK_ILP a thread at once, the loads
//       of each step issued together.
// The longest chain falls from a whole span's ~2.3 k steps to ~2 S / 3.5 +
// W / S + S / 3.5. A token's end goes to cell e - 1 - k of a (W,) array
// (the k-th token from its span's end), so a span's tokens lie in
// position order in [e - ntok, e); ids mode writes cell c's id to flat
// slot c + incl[k] - e, and its first launch leaves the exit tables for
// the second. Count mode folds equal ids of a warp (__match_any_sync),
// then of the block in a shared open-addressed table, before its device-
// wide atomics. Spans go through the block T at a time (a tile), sorted by
// start, so a cell finds its span by a binary search over the tile's ends.
// The Viterbi kernels leave best_l as (W, B) int32, where a row's
// elements lie B apart: `walk_rows_kernel` first copies it to (B, W)
// bytes through shared-memory tiles, so every block stages its row with
// 16-byte loads.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tokengeex_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define TGX_WALK_THREADS 256
#define TGX_WALK_HASH_BITS 10  // count mode's shared table of ids
#define TGX_WALK_STAGE 8  // backpointer loads a thread keeps in flight
#define TGX_WALK_ILP 4  // tokens a thread resolves at once
#define TGX_NO_TOKEN 0xFFFFu

// Index mixers of the two cuckoo tables (ops/hashing.py).
#define TGX_IDX_A1 0x27D4EB2Fu
#define TGX_IDX_M1 0x165667B1u
#define TGX_IDX_A2 0x9E3779B9u
#define TGX_IDX_M2 0xC2B2AE35u

enum { TGX_WALK_COUNT = 0, TGX_WALK_NTOK = 1, TGX_WALK_IDS = 2 };

struct WalkArgs {
  const void* bl;          // best_l, element (b, p) at b * bl_sr + p * bl_sp
  const int32_t* p1;       // (B, p_stride) prefix hashes, dp index p at pad+p
  const int32_t* p2;
  const int32_t* rinv1;    // (pad + W,) inverse powers, dp index p at pad + p
  const int32_t* rinv2;
  const int4* t1;          // (H, 4) exact rows [fp1, fp2, len << 24 | id, 0]
  const int4* t2;
  const int32_t* row_ptr;  // (B + 1,) spans of row b: order[row_ptr[b]..]
  const int32_t* order;    // non-empty spans sorted by (row, start)
  const int32_t* sp_start; // (n,) dp index of each span's start
  const int32_t* sp_end;   // (n,) dp index of each span's end
  const uint8_t* ok;       // (n,) 0: do not walk
  int32_t* counts;         // (V + 1,) count mode
  int32_t* ntok;           // (n,) written in ntok mode, read in ids mode
  const int32_t* incl;     // (n,) inclusive cumsum of ntok, ids mode
  int32_t* flat;           // (>= total,) ids mode
  uint8_t* tabs;           // (B, 4 NS L) exit tables: ntok mode writes
                           // them, ids mode reads them (null: build)
  long long bl_sr, bl_sp;
  int W, p_stride, pad, bits, V, L, S;
};

// Shared memory of one block: byte offsets of its arrays and the total.
// Tile ends and deltas (int32); the cells and the dense list of recorded
// cells (uint16, not in ntok mode), the token-count table and the segment
// records (uint16); the backpointers (16-aligned) and the exit table.
struct WalkSmem {
  size_t tok, dense, tn, seg_q, seg_c, sbl, tx, total;
};

__host__ __device__ inline WalkSmem walk_smem(int W, int L, int S,
                                              int mode) {
  const size_t ns = (size_t)((W + S - 1) / S);
  const size_t cells = mode == TGX_WALK_NTOK ? 0 : 2 * (size_t)W;
  WalkSmem m;
  m.tok = 2 * sizeof(int32_t) * TGX_WALK_THREADS;
  m.dense = m.tok + cells;
  m.tn = m.dense + cells;
  m.seg_q = m.tn + 2 * ns * L;
  m.seg_c = m.seg_q + 2 * ns;
  m.sbl = (m.seg_c + 2 * ns + 15) & ~(size_t)15;
  m.tx = m.sbl + (size_t)W;
  m.total = m.tx + ns * L;
  return m;
}

// Count mode folds a block's counts in a shared open-addressed table of
// ids before the device-wide atomics; an id that finds no slot within a
// few probes adds to the global bin at once. Integer adds, so the counts
// stay exact in any order.
__device__ __forceinline__ void count_add(int32_t* counts, int* hkey,
                                          int* hcnt, int id, int c) {
  unsigned h = ((unsigned)id * 2654435761u) >> (32 - TGX_WALK_HASH_BITS);
  for (int probe = 0; probe < 8; ++probe) {
    int k = hkey[h];
    if (k == -1) k = atomicCAS(hkey + h, -1, id);
    if (k == -1 || k == id) {
      atomicAdd(hcnt + h, c);
      return;
    }
    h = (h + 1) & ((1u << TGX_WALK_HASH_BITS) - 1);
  }
  atomicAdd(counts + id, c);
}

__device__ __forceinline__ int walk_step(const uint8_t* sbl, int q) {
  const int l = sbl[q - 1];
  return q - (l > 0 ? l : 1);
}

template <typename BL, int MODE>
__global__ void __launch_bounds__(TGX_WALK_THREADS)
viterbi_walk_kernel(const WalkArgs a) {
  const int b = blockIdx.x;
  const int s0 = a.row_ptr[b], s1 = a.row_ptr[b + 1];
  if (s0 == s1) return;
  const int W = a.W, L = a.L, S = a.S;
  const int NS = (W + S - 1) / S;
  const bool emit = MODE != TGX_WALK_NTOK;
  extern __shared__ __align__(16) unsigned char smem[];
  const WalkSmem m = walk_smem(W, L, S, MODE);
  int32_t* tile_e = (int32_t*)smem;               // (T,) span ends
  int32_t* tile_d = tile_e + TGX_WALK_THREADS;    // (T,) flat slot - cell
  uint16_t* tok = (uint16_t*)(smem + m.tok);      // (W,) token ends by cell
  uint16_t* dense = (uint16_t*)(smem + m.dense);  // (W,) recorded cells
  uint16_t* tn = (uint16_t*)(smem + m.tn);        // (NS, L) tokens
  uint16_t* seg_q = (uint16_t*)(smem + m.seg_q);  // (NS,) real entry, 0: none
  uint16_t* seg_c = (uint16_t*)(smem + m.seg_c);  // (NS,) its first cell
  uint8_t* sbl = smem + m.sbl;                    // (W,) backpointers
  uint8_t* tx = smem + m.tx;                      // (NS, L) exit offsets
  __shared__ int tile_lo, tile_hi, warp_sum[TGX_WALK_THREADS / 32];
  constexpr int HS = MODE == TGX_WALK_COUNT ? 1 << TGX_WALK_HASH_BITS : 1;
  __shared__ int hkey[HS], hcnt[HS];

  // Stage the row's backpointers, TGX_WALK_STAGE loads a thread in
  // flight; no token recorded yet.
  const BL* bl = (const BL*)a.bl + (long long)b * a.bl_sr;
  if (sizeof(BL) == 1 && a.bl_sp == 1 && (W & 15) == 0 &&
      ((uintptr_t)bl & 15) == 0) {
    // Contiguous bytes (the transposed copy): 16 a load.
    for (int p = 16 * threadIdx.x; p < W; p += 16 * TGX_WALK_THREADS) {
      *(uint4*)(sbl + p) = __ldg((const uint4*)(bl + p));
      if (emit) {
        const uint4 none = make_uint4(~0u, ~0u, ~0u, ~0u);
        *(uint4*)(tok + p) = none;
        *(uint4*)(tok + p + 8) = none;
      }
    }
  } else for (int p0 = threadIdx.x; p0 < W;
              p0 += TGX_WALK_STAGE * TGX_WALK_THREADS) {
    BL v[TGX_WALK_STAGE];
#pragma unroll
    for (int u = 0; u < TGX_WALK_STAGE; ++u) {
      const int p = p0 + u * TGX_WALK_THREADS;
      v[u] = p < W ? __ldg(bl + (long long)p * a.bl_sp) : (BL)0;
    }
#pragma unroll
    for (int u = 0; u < TGX_WALK_STAGE; ++u) {
      const int p = p0 + u * TGX_WALK_THREADS;
      if (p < W) {
        sbl[p] = (uint8_t)v[u];
        if (emit) tok[p] = TGX_NO_TOKEN;
      }
    }
  }
  for (int g = threadIdx.x; g < NS; g += blockDim.x) seg_q[g] = 0;
  if (MODE == TGX_WALK_COUNT) {
    for (int h = threadIdx.x; h < HS; h += blockDim.x) {
      hkey[h] = -1;
      hcnt[h] = 0;
    }
  }
  __syncthreads();

  // (a) The speculative walks: every entry t of every segment g, down to
  // the segment's bottom lo = g * S, two entries a thread at once so their
  // chains overlap. Entries above W are never entered.
  const int NE = NS * L;
  uint16_t* g_tn = a.tabs ? (uint16_t*)(a.tabs + 4LL * NE * b) : nullptr;
  uint8_t* g_tx = a.tabs ? a.tabs + 4LL * NE * b + 2 * NE : nullptr;
  if (MODE == TGX_WALK_IDS && a.tabs != nullptr) {
    // The tables of this row, as the ntok launch left them.
    for (int j = threadIdx.x; j < NE; j += TGX_WALK_THREADS) {
      tn[j] = g_tn[j];
      tx[j] = g_tx[j];
    }
  } else {
    for (int j0 = threadIdx.x; j0 < NE; j0 += 2 * TGX_WALK_THREADS) {
      const int j1 = min(j0 + TGX_WALK_THREADS, NE - 1);
      const int g0 = j0 / L, g1 = j1 / L, lo0 = g0 * S, lo1 = g1 * S;
      int q0 = lo0 + S - (j0 - g0 * L), q1 = lo1 + S - (j1 - g1 * L);
      if (q0 > W) q0 = lo0;
      if (q1 > W) q1 = lo1;
      int n0 = 0, n1 = 0;
      while (q0 > lo0 || q1 > lo1) {
        const bool go0 = q0 > lo0, go1 = q1 > lo1;
        const int l0 = sbl[max(q0, 1) - 1], l1 = sbl[max(q1, 1) - 1];
        q0 -= go0 ? (l0 > 0 ? l0 : 1) : 0;
        q1 -= go1 ? (l1 > 0 ? l1 : 1) : 0;
        n0 += go0;
        n1 += go1;
      }
      tn[j0] = (uint16_t)n0;
      tx[j0] = (uint8_t)(lo0 - q0);
      if (j1 == j0 + TGX_WALK_THREADS) {
        tn[j1] = (uint16_t)n1;
        tx[j1] = (uint8_t)(lo1 - q1);
      }
      if (MODE == TGX_WALK_NTOK && a.tabs != nullptr) {
        g_tn[j0] = (uint16_t)n0;
        g_tx[j0] = (uint8_t)(lo0 - q0);
        if (j1 == j0 + TGX_WALK_THREADS) {
          g_tn[j1] = (uint16_t)n1;
          g_tx[j1] = (uint8_t)(lo1 - q1);
        }
      }
    }
  }
  __syncthreads();

  const unsigned shift = 32u - (unsigned)a.bits;
  const long long rowp = (long long)b * a.p_stride + a.pad;
  for (int t0 = s0; t0 < s1; t0 += TGX_WALK_THREADS) {
    const int i = t0 + threadIdx.x;
    const int last = min(s1, t0 + TGX_WALK_THREADS) - 1;
    int e = INT_MAX, n = 0, k = -1;
    if (i <= last) {
      k = a.order[i];
      // Clamped into [0, W], as the scans clamp their chains: the bounds
      // are checked on the CPU only, where a check costs no sync.
      e = min(max(a.sp_end[k], 0), W);
      const int s = min(max(a.sp_start[k], 0), e);
      if (i == t0) tile_lo = s;
      if (i == last) tile_hi = e;
      // (b) The composition: whole segments by their tables, the rest
      // step by step (also where an exit lies beyond the table's reach).
      int q = a.ok[k] ? e : s;
      while (q > s) {
        const int g = (q - 1) / S, lo = g * S, t = lo + S - q;
        if (lo >= s && t < L) {
          if (emit) {
            seg_q[g] = (uint16_t)q;
            seg_c[g] = (uint16_t)(e - 1 - n);
          }
          n += tn[g * L + t];
          q = lo - tx[g * L + t];
        } else {
          const int stop = max(lo, s);
          while (q > stop) {
            if (emit) tok[e - 1 - n] = (uint16_t)(q - 1);
            q = walk_step(sbl, q);
            ++n;
          }
        }
      }
      if (MODE == TGX_WALK_NTOK) a.ntok[k] = n;
    }
    if (MODE == TGX_WALK_NTOK) continue;
    if (MODE == TGX_WALK_IDS) {
      tile_e[threadIdx.x] = e;
      tile_d[threadIdx.x] = k >= 0 ? a.incl[k] - e : 0;
    }
    __syncthreads();

    // (c) The recorded whole segments, walked from their real entries.
    for (int g = threadIdx.x; g < NS; g += blockDim.x) {
      int q = seg_q[g];
      if (q == 0) continue;
      seg_q[g] = 0;
      int c = seg_c[g];
      const int lo = g * S;
      while (q > lo) {
        tok[c--] = (uint16_t)(q - 1);
        q = walk_step(sbl, q);
      }
    }
    __syncthreads();

    // The tile's recorded cells into a dense list, in cell order: each
    // thread counts its own run of cells (8-aligned, 8 a load), then a
    // block scan places them.
    const int lo_c = tile_lo, hi_c = tile_hi;
    const int base = lo_c & ~7;
    const int run = (hi_c - base + 8 * TGX_WALK_THREADS - 1) /
                    (8 * TGX_WALK_THREADS) * 8;
    const int c_a = base + (int)threadIdx.x * run;
    const int c_b = min(c_a + run, hi_c);
    int mine = 0;
    for (int c = c_a; c < c_b; c += 8) {
      const uint4 v = *(const uint4*)(tok + c);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned t = (w[i >> 1] >> (16 * (i & 1))) & 0xFFFFu;
        mine += t != TGX_NO_TOKEN && c + i >= lo_c && c + i < hi_c;
      }
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = lane < TGX_WALK_THREADS / 32 ? warp_sum[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, w, o);
        if (lane >= o) w += y;
      }
      if (lane < TGX_WALK_THREADS / 32) warp_sum[lane] = w;
    }
    __syncthreads();
    int at = incl - mine + (warp > 0 ? warp_sum[warp - 1] : 0);
    const int ntile = warp_sum[TGX_WALK_THREADS / 32 - 1];
    for (int c = c_a; c < c_b; c += 8) {
      const uint4 v = *(const uint4*)(tok + c);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned t = (w[i >> 1] >> (16 * (i & 1))) & 0xFFFFu;
        if (t != TGX_NO_TOKEN && c + i >= lo_c && c + i < hi_c)
          dense[at++] = (uint16_t)(c + i);
      }
    }
    __syncthreads();

    // The ids: TGX_WALK_ILP tokens a thread at once, their loads issued
    // together.
    const int32_t* p1 = a.p1 + rowp;
    const int32_t* p2 = a.p2 + rowp;
    for (int j0 = 0; j0 < ntile; j0 += TGX_WALK_ILP * TGX_WALK_THREADS) {
      int c[TGX_WALK_ILP], te[TGX_WALK_ILP], st[TGX_WALK_ILP];
      unsigned l[TGX_WALK_ILP];
#pragma unroll
      for (int u = 0; u < TGX_WALK_ILP; ++u) {
        const int j = j0 + u * TGX_WALK_THREADS + (int)threadIdx.x;
        c[u] = j < ntile ? dense[j] : -1;
        const unsigned pos = c[u] >= 0 ? tok[c[u]] : 0u;
        const unsigned lb = sbl[pos];
        l[u] = lb > 0 ? lb : 1u;
        te[u] = (int)pos + 1;
        st[u] = te[u] - (int)l[u];
        if (c[u] < 0) te[u] = st[u] = 0;  // loads in range, result unused
      }
      uint32_t fp1[TGX_WALK_ILP], fp2[TGX_WALK_ILP];
#pragma unroll
      for (int u = 0; u < TGX_WALK_ILP; ++u) {
        fp1[u] = ((uint32_t)__ldg(p1 + te[u]) - (uint32_t)__ldg(p1 + st[u])) *
                 (uint32_t)__ldg(a.rinv1 + a.pad + st[u]);
        fp2[u] = ((uint32_t)__ldg(p2 + te[u]) - (uint32_t)__ldg(p2 + st[u])) *
                 (uint32_t)__ldg(a.rinv2 + a.pad + st[u]);
      }
      int4 r1[TGX_WALK_ILP], r2[TGX_WALK_ILP];
#pragma unroll
      for (int u = 0; u < TGX_WALK_ILP; ++u) {
        const uint32_t i1 =
            ((fp1[u] ^ (l[u] * TGX_IDX_A1)) * TGX_IDX_M1) >> shift;
        const uint32_t i2 =
            ((fp2[u] ^ (l[u] * TGX_IDX_A2)) * TGX_IDX_M2) >> shift;
        r1[u] = __ldg(a.t1 + i1);
        r2[u] = __ldg(a.t2 + i2);
      }
#pragma unroll
      for (int u = 0; u < TGX_WALK_ILP; ++u) {
        int id = -1;
        if (c[u] >= 0) {
          id = a.V;
          if ((uint32_t)r1[u].x == fp1[u] && (uint32_t)r1[u].y == fp2[u] &&
              ((uint32_t)r1[u].z >> 24) == l[u]) {
            id = r1[u].z & 0xFFFFFF;
          } else if ((uint32_t)r2[u].x == fp1[u] &&
                     (uint32_t)r2[u].y == fp2[u] &&
                     ((uint32_t)r2[u].z >> 24) == l[u]) {
            id = r2[u].z & 0xFFFFFF;
          }
        }
        if (MODE == TGX_WALK_COUNT) {
          // One atomic per distinct id of the warp (the loop is uniform
          // over the block, so every lane is here).
          const unsigned same = __match_any_sync(0xFFFFFFFFu, id);
          if (id >= 0 && lane == __ffs(same) - 1)
            count_add(a.counts, hkey, hcnt, id, __popc(same));
        } else if (id >= 0) {
          // The cell's span: the tile's first span ending after it (spans
          // are disjoint and sorted by start, so their ends rise).
          int lo = 0, up = last - t0;
          while (lo < up) {
            const int mid = (lo + up) >> 1;
            if (tile_e[mid] > c[u]) up = mid; else lo = mid + 1;
          }
          a.flat[c[u] + tile_d[lo]] = id;
        }
      }
    }
    __syncthreads();
  }
  if (MODE == TGX_WALK_COUNT) {
    for (int h = threadIdx.x; h < HS; h += blockDim.x)
      if (hcnt[h] > 0) atomicAdd(a.counts + hkey[h], hcnt[h]);
  }
}

// A row group's backpointers as (B, W) bytes, from any strides: tiles of
// 128 positions x 32 rows through shared memory, so that a (W, B) layout
// (the Viterbi kernels' own: one row per lane) is read along its rows,
// 128 bytes a warp, and written along the walk's, four positions a
// thread. The walk then stages each row with 16-byte loads.
template <typename BL>
__global__ void __launch_bounds__(256)
walk_rows_kernel(const BL* __restrict__ bl, uint8_t* __restrict__ out,
                 long long sr, long long sp, int B, int W) {
  __shared__ uint8_t tile[128][33];
  const int p0 = blockIdx.x * 128, b0 = blockIdx.y * 32;
  const int b = b0 + threadIdx.x;
#pragma unroll
  for (int j = threadIdx.y; j < 128; j += 8) {
    const int p = p0 + j;
    tile[j][threadIdx.x] =
        p < W && b < B ? (uint8_t)__ldg(bl + b * sr + p * sp) : 0;
  }
  __syncthreads();
  const int p = p0 + 4 * threadIdx.x;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int r = b0 + j;
    if (r >= B || p >= W) continue;
    const int i = 4 * threadIdx.x;
    uint8_t* o = out + (long long)r * W + p;
    if (p + 3 < W && (((uintptr_t)o) & 3) == 0) {
      *(uint32_t*)o = (uint32_t)tile[i][j] | (uint32_t)tile[i + 1][j] << 8 |
                      (uint32_t)tile[i + 2][j] << 16 |
                      (uint32_t)tile[i + 3][j] << 24;
    } else {
      for (int k = 0; k < 4 && p + k < W; ++k) o[k] = tile[i + k][j];
    }
  }
}

template <typename BL, int MODE>
static int launch(const WalkArgs& a, int B, cudaStream_t stream) {
  const size_t smem = walk_smem(a.W, a.L, a.S, MODE).total;
  // Past 48 KB a block needs the opt-in, static shared memory included.
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, viterbi_walk_kernel<BL, MODE>);
  if (err != cudaSuccess) return (int)err;
  if (smem + attr.sharedSizeBytes > 48 * 1024) {
    err = cudaFuncSetAttribute(viterbi_walk_kernel<BL, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  viterbi_walk_kernel<BL, MODE><<<B, TGX_WALK_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename BL>
static int launch_mode(const WalkArgs& a, int mode, int B, cudaStream_t s) {
  if (mode == TGX_WALK_COUNT) return launch<BL, TGX_WALK_COUNT>(a, B, s);
  if (mode == TGX_WALK_NTOK) return launch<BL, TGX_WALK_NTOK>(a, B, s);
  return launch<BL, TGX_WALK_IDS>(a, B, s);
}

// mode 0: count (counts); 1: ntok (ntok); 2: ids (ntok and incl read,
// flat written). tabs, when not null, holds (B, 4 NS L) bytes, NS the
// segments of a row: the ntok launch leaves each row's exit tables
// there and the ids launch reads them instead of walking them again.
// best_l elements are bl_bytes wide (1: uint8, 4: int32),
// strides in elements; W < 65535 (cells are kept as uint16); L the
// longest token (the exit tables' reach), L <= S, the segment length.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tgx_viterbi_walk(
    const void* bl, const int32_t* p1, const int32_t* p2,
    const int32_t* rinv1, const int32_t* rinv2, const int32_t* t1,
    const int32_t* t2, const int32_t* row_ptr, const int32_t* order,
    const int32_t* sp_start, const int32_t* sp_end, const uint8_t* ok,
    int32_t* counts, int32_t* ntok, const int32_t* incl, int32_t* flat,
    uint8_t* tabs, long long bl_sr, long long bl_sp, int bl_bytes, int B,
    int W, int p_stride, int pad, int bits, int V, int L, int S, int mode,
    void* stream) {
  if (B < 1 || W < 1 || W >= (int)TGX_NO_TOKEN || bits < 1 || bits > 31 ||
      (bl_bytes != 1 && bl_bytes != 4) || ok == nullptr || L < 1 ||
      L > 255 || S < L || S > 65535 ||
      (mode == TGX_WALK_COUNT && counts == nullptr) ||
      (mode == TGX_WALK_NTOK && ntok == nullptr) ||
      (mode == TGX_WALK_IDS &&
       (ntok == nullptr || incl == nullptr || flat == nullptr)) ||
      mode < 0 || mode > 2 ||
      walk_smem(W, L, S, mode).total > 232448 - 9 * 1024)
    return (int)cudaErrorInvalidValue;
  WalkArgs a = {};
  a.bl = bl;
  a.p1 = p1;
  a.p2 = p2;
  a.rinv1 = rinv1;
  a.rinv2 = rinv2;
  a.t1 = (const int4*)t1;
  a.t2 = (const int4*)t2;
  a.row_ptr = row_ptr;
  a.order = order;
  a.sp_start = sp_start;
  a.sp_end = sp_end;
  a.ok = ok;
  a.counts = counts;
  a.ntok = ntok;
  a.incl = incl;
  a.flat = flat;
  a.tabs = tabs;
  a.bl_sr = bl_sr;
  a.bl_sp = bl_sp;
  a.W = W;
  a.p_stride = p_stride;
  a.pad = pad;
  a.bits = bits;
  a.V = V;
  a.L = L;
  a.S = S;
  cudaStream_t s = (cudaStream_t)stream;
  return bl_bytes == 1 ? launch_mode<uint8_t>(a, mode, B, s)
                       : launch_mode<int32_t>(a, mode, B, s);
}

// best_l (elements bl_bytes wide, strides in elements) into out, a
// contiguous (B, W) uint8 array. Returns cudaGetLastError() after the
// launch.
extern "C" int tgx_walk_rows(const void* bl, uint8_t* out, long long bl_sr,
                             long long bl_sp, int bl_bytes, int B, int W,
                             void* stream) {
  if (B < 1 || W < 1 || (bl_bytes != 1 && bl_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + 127) / 128, (B + 31) / 32), block(32, 8);
  cudaStream_t s = (cudaStream_t)stream;
  if (bl_bytes == 1)
    walk_rows_kernel<uint8_t><<<grid, block, 0, s>>>(
        (const uint8_t*)bl, out, bl_sr, bl_sp, B, W);
  else
    walk_rows_kernel<int32_t><<<grid, block, 0, s>>>(
        (const int32_t*)bl, out, bl_sr, bl_sp, B, W);
  return (int)cudaGetLastError();
}

