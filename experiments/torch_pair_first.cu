// The first design of tokengeex_tpu_torch/csrc/pair_count.cu (one thread
// a token, every pair a global atomic, keys and counts in two arrays, a
// table sized from the pairs), kept with its C interface for
// experiments/torch_pair_design.py and chip_smoke.py, which time it beside
// the package's kernel in one process. Not built by the package.
//
// Adjacent-id pair counts in an open-addressing hash table, for Hopper
// (sm_90a).
//
// Replaces: no TPU kernel. The JAX package counts merge's pairs on the
// host: natively (native/tokengeex_native.cpp `tg_count_pairs`, a threaded
// hash count of (a << 32) | b keys) or, on its device route, with np.unique
// over the walked ids read back into one list per sample
// (tokengeex_tpu/train/estep_device.py `count_pairs_device`).
//
// What it computes: for every span of a row group's walked ids (the flat
// int32 buffer of `viterbi_walk` ids mode, span k's ids at
// [incl[k] - ntok[k], incl[k]), incl the inclusive cumsum of the tokens
// per span), the count of each key (a << 32) | b of two adjacent ids a, b
// of one span. Spans are whole samples, so no pair straddles two samples.
// The counts are integers: the table's content is exact whatever the order
// the atomics land in.
//
// The table: `keys` (slots,) uint64, EMPTY = ~0, and `counts` (slots,)
// uint64, slots a power of two; a key's first slot is murmur3's fmix64 of
// the key masked by slots - 1, then linear probing. A claim is atomicCAS on
// the key, a count atomicAdd. Ids are below 2^31, so no real key is EMPTY.
// `state` (3,) uint64: the distinct keys claimed, an overflow flag (a
// probe ran over every slot and found neither its key nor a free slot) and
// a mismatch flag (an id >= V, the walk's value for a token no table row
// holds). The caller sizes the table at twice the keys it can hold
// (ops/pair_count.py), so a probe stays short and overflow cannot happen;
// the flag makes the host raise if it ever does.
//
// Three entry points:
//   - tgx_pair_insert_ids: one thread per token i < incl[n - 1], grid-
//     stride; it flags a mismatch and inserts (flat[i], flat[i + 1]) with
//     weight 1 unless i is the last token of its span. The boundary comes
//     from a binary search of i over incl (the first k with incl[k] > i; i
//     is last iff incl[k] == i + 1): incl holds one int32 a span (a few
//     thousand a group), so its ~12 probes hit L1 and the launch needs no
//     scratch mask and no second launch to scatter one. The token count is
//     read on the device (incl[n - 1]); the grid is sized from the host's
//     bound `max_tokens`, so nothing is read back before the launch;
//   - tgx_pair_insert_weighted: (key, count) rows, one thread a row; a row
//     whose key is EMPTY is skipped, so a grown table takes the old table's
//     slots as they lie (the rehash) and another table's compacted rows
//     alike (ranks' tables, chained samples' pairs);
//   - tgx_pair_compact: the used slots written densely to (out_keys,
//     out_counts) through an atomic cursor, one atomicAdd a warp (a ballot
//     of its used slots), at most out_cap rows (the cursor still counts
//     them all, so the host sees a short buffer). The order is free; the
//     caller sorts.
//
// What bounds it on the H100: bytes, at random addresses: the ids read
// once (4 B a token) and ~16 B of table traffic a pair (the key's compare
// or CAS, the count's atomicAdd), with atomics on hot keys (the most
// frequent pairs) serialising in L2. A merge pass's table (~2 x 10^5
// distinct keys, ~6 MB of touched sectors) stays in the 50 MB L2.
//
// What the design does about it: nothing beyond the plain scheme yet: one
// thread a token, the table in device memory, keys and counts in two
// arrays (a slot's two words in separate sectors).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr u64 kEmpty = ~0ull;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ u64 fmix64(u64 k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdull;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ull;
  k ^= k >> 33;
  return k;
}

// Adds w to key's count, claiming a free slot for a new key. A key slot
// goes from EMPTY to its key once and never changes after, so a plain read
// that finds a key is current; one that finds EMPTY is settled by the CAS.
__device__ __forceinline__ void insert(u64* keys, u64* counts, u64 mask,
                                       u64* state, u64 key, u64 w) {
  u64 slot = fmix64(key) & mask;
  for (u64 probe = 0; probe <= mask; ++probe) {
    u64 cur = keys[slot];
    if (cur == kEmpty) {
      cur = atomicCAS(&keys[slot], kEmpty, key);
      if (cur == kEmpty) {
        atomicAdd(&state[0], 1ull);
        atomicAdd(&counts[slot], w);
        return;
      }
    }
    if (cur == key) {
      atomicAdd(&counts[slot], w);
      return;
    }
    slot = (slot + 1) & mask;
  }
  state[1] = 1;  // overflow: every slot holds another key
}

__global__ void insert_ids_kernel(const int32_t* __restrict__ flat,
                                  const int32_t* __restrict__ incl, int n,
                                  unsigned V, u64* keys, u64* counts,
                                  u64 mask, u64* state) {
  const long long total = incl[n - 1];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const unsigned a = (unsigned)flat[i];
    if (a >= V) state[2] = 1;  // the walk's mismatch value (or worse)
    int lo = 0, hi = n - 1;    // incl[n - 1] = total > i: a k exists
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (incl[mid] > i)
        hi = mid;
      else
        lo = mid + 1;
    }
    if (incl[lo] == i + 1) continue;  // the last token of its span
    const unsigned b = (unsigned)flat[i + 1];
    insert(keys, counts, mask, state, ((u64)a << 32) | b, 1ull);
  }
}

__global__ void insert_weighted_kernel(const u64* __restrict__ in_keys,
                                       const u64* __restrict__ in_counts,
                                       long long m, u64* keys, u64* counts,
                                       u64 mask, u64* state) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    const u64 key = in_keys[i];
    if (key != kEmpty) insert(keys, counts, mask, state, key, in_counts[i]);
  }
}

__global__ void compact_kernel(const u64* __restrict__ keys,
                               const u64* __restrict__ counts,
                               long long slots, u64* out_keys,
                               u64* out_counts, u64 out_cap, u64* cursor) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // base is uniform over a warp (blockDim a multiple of 32), so every lane
  // takes part in each ballot.
  for (long long base = (long long)blockIdx.x * blockDim.x; base < slots;
       base += stride) {
    const long long i = base + threadIdx.x;
    const bool used = i < slots && keys[i] != kEmpty;
    const unsigned ballot = __ballot_sync(0xffffffffu, used);
    if (!ballot) continue;
    u64 first = 0;
    if (lane == 0) first = atomicAdd(cursor, (u64)__popc(ballot));
    first = __shfl_sync(0xffffffffu, first, 0);
    if (used) {
      const u64 j = first + __popc(ballot & ((1u << lane) - 1u));
      if (j >= out_cap) continue;
      out_keys[j] = keys[i];
      out_counts[j] = counts[i];
    }
  }
}

int grid_for(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  return (int)(blocks < 1 ? 1 : blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

bool bad_slots(long long slots) {
  return slots <= 0 || (slots & (slots - 1)) != 0;
}

}  // namespace

// Inserts the adjacent pairs of n spans' ids: flat (>= max_tokens,) int32,
// incl (n,) int32 inclusive offsets, max_tokens a bound of incl[n - 1] (the
// grid's size). Returns cudaGetLastError() after the launch.
extern "C" int tgx_pair_insert_ids(const int32_t* flat, const int32_t* incl,
                                   int n, unsigned V, u64* keys, u64* counts,
                                   long long slots, u64* state,
                                   long long max_tokens, void* stream) {
  if (n < 1 || bad_slots(slots)) return (int)cudaErrorInvalidValue;
  if (max_tokens < 1) return (int)cudaSuccess;
  insert_ids_kernel<<<grid_for(max_tokens), kThreads, 0,
                      (cudaStream_t)stream>>>(flat, incl, n, V, keys, counts,
                                              (u64)(slots - 1), state);
  return (int)cudaGetLastError();
}

// Adds m (key, count) rows, skipping EMPTY keys.
extern "C" int tgx_pair_insert_weighted(const u64* in_keys,
                                        const u64* in_counts, long long m,
                                        u64* keys, u64* counts,
                                        long long slots, u64* state,
                                        void* stream) {
  if (m < 0 || bad_slots(slots)) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  insert_weighted_kernel<<<grid_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      in_keys, in_counts, m, keys, counts, (u64)(slots - 1), state);
  return (int)cudaGetLastError();
}

// Writes the used slots to out_keys / out_counts (out_cap rows each) from
// *cursor on (the caller zeroes it) and advances *cursor past them.
extern "C" int tgx_pair_compact(const u64* keys, const u64* counts,
                                long long slots, u64* out_keys,
                                u64* out_counts, long long out_cap,
                                u64* cursor, void* stream) {
  if (bad_slots(slots) || out_cap < 0) return (int)cudaErrorInvalidValue;
  compact_kernel<<<grid_for(slots), kThreads, 0, (cudaStream_t)stream>>>(
      keys, counts, slots, out_keys, out_counts, (u64)out_cap, cursor);
  return (int)cudaGetLastError();
}
