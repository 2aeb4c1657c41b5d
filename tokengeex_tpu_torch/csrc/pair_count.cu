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
// The table: (slots,) slots of 16 bytes, {u64 key, u64 count - 1},
// 16-byte aligned, a free slot {EMPTY, EMPTY} with EMPTY = ~0 (so one fill
// makes a table), slots a power of two; a key's first slot is murmur3's
// fmix64 of the key masked by slots - 1, then linear probing. A claim is
// atomicCAS on the key, a count atomicAdd on the word beside it: one
// sector. Ids are below 2^31, so no real key is EMPTY. A row that
// finds neither its key nor a free slot within `max_probe` slots is
// appended to the spill buffer ((spill_cap,) slots, allocated by the
// caller at the rows the launch can send, not filled) and counted in
// state[3]; the host grows the table and inserts the spilled rows through
// the weighted entry (ops/pair_count.py `PairTable.reserve`), so no row is
// lost and none is counted twice. `state` (6,) uint64: the distinct keys
// claimed, an overflow flag (a row that found no slot and no room in the
// spill buffer), a mismatch flag (an id >= V, the walk's value for a
// token no table row holds), the spilled rows, the rows sent to the table
// (for the logs) and the compaction's cursor. Counters are summed in the
// block and added once a block.
//
// Three entry points:
//   - tgx_pair_insert_ids: persistent blocks (as many as fit on the card,
//     two an SM), each over a contiguous range of the flat ids, in tiles of
//     kTile tokens staged into shared memory with 16-byte loads.
//     The block finds the span holding its first token once (a binary
//     search over incl) and then walks incl forward a tile at a time,
//     marking each span's last token in a shared bitmap, so a token needs
//     no search. The token count is read on the device (incl[n - 1]); the
//     grid is sized from the host's bound `max_tokens`, so nothing is read
//     back before the launch. Each pair is counted in the block's own
//     open-addressing table in dynamic shared memory
//     (kShared slots: u64 keys, u32 counts; shared-memory
//     atomics; a fold of equal keys in a warp first, __match_any_sync,
//     cost more than it saved on the merge's and a skewed group,
//     experiments/torch_pair_design.py). When that table is over half
//     full after a tile, and
//     when the range is done, the block sends each of its distinct rows
//     once to the global table and clears it, a thread's rows four at a
//     time (their first probes loaded together). A pair that finds the
//     shared table full goes straight to the global table;
//   - tgx_pair_insert_weighted: (key, count) rows, one thread a row, `stride`
//     words between rows (1 for two arrays, 2 for a table's or a spill
//     buffer's slots) and `bias` added to each count (1 for a table's
//     slots); a row whose key is EMPTY is skipped, so a grown table takes
//     the old table's slots as they lie (the rehash) and another table's
//     compacted rows alike (ranks' tables, chained samples' pairs);
//   - tgx_pair_compact: the used slots written densely to (out_keys,
//     out_counts) through the state's cursor, one atomicAdd a block (a
//     block scan of its threads' used slots, kCompactPer slots a thread,
//     each read as one 16-byte load), at most out_cap rows (the cursor
//     still counts them all, so the host sees a short buffer). The order
//     is free; the caller sorts.
//
// What bounds it on the H100: the function's bytes are the ids read once
// and each distinct row written once (~9.5 MB at merge's 1.64 M-token
// group: ~3 us). The first design (experiments/torch_pair_first.cu) spent
// ~0.14 ms of its insert on a global atomic a pair into two-sector slots:
// a code corpus's pairs are Zipf-skewed, and the frequent keys' atomics
// serialise in one L2 slice (a skewed group, one key 64 % of the pairs:
// ~0.97 ms).
//
// What the design does about it: the block's shared table turns a hot
// key's thousands of global atomics into one a block; a slot's key and
// count share a sector; the caller sizes the table at about twice a bound
// on the distinct keys (the merge loop's hint: the last pass's distinct
// count), not on the pairs, so the table stays in the 50 MB L2 (2^19
// slots, 8 MB, at the merge group), and a wrong hint costs a spill and a
// regrow, not a wrong count. What is left (experiments/torch_pair_design.py
// on an H100 SXM, the merge group's ~81 us insert): the staging ~5 us,
// the shared fold ~30 us (~11 of it its claims' shared CAS), the global
// sends ~45 us: this corpus repeats few pairs inside a block's ~6,200
// tokens, so ~1.5 M rows still reach the global table, each an L2 load
// and an atomic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr u64 kEmpty = ~0ull;
constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;
constexpr int kShared = 8192;  // a power of two
constexpr int kTile = 4096;    // a multiple of 32
constexpr int kSharedProbe = 32;
constexpr int kRowThreads = 256;
constexpr int kMaxRowBlocks = 132 * 16;
constexpr int kCompactPer = 8;  // slots a compaction thread reads
constexpr int kBatch = 4;       // rows a flushing thread probes at once

static_assert((kShared & (kShared - 1)) == 0, "shared slots: a power of 2");
static_assert(kTile % 32 == 0 && kThreads % 32 == 0, "tile, block: warps");

enum {
  kDistinct = 0,
  kOverflow = 1,
  kMismatch = 2,
  kSpilled = 3,
  kSent = 4,
  kCursor = 5
};

struct __align__(16) Slot {
  u64 key;
  u64 count;
};

// Dynamic shared memory of the ids kernel: the block's table (keys, then
// counts), the tile's ids (one more than the tile: the next token) and the
// tile's last-token bitmap.
constexpr size_t kSmemBytes = (size_t)kShared * 8 + (size_t)kShared * 4 +
                              (size_t)(kTile + 4) * 4 + (size_t)kTile / 8;
// An SM has 228 KB of shared memory, 1 KB of it reserved a block.
static_assert(kBlocksPerSm * (kSmemBytes + 1024) <= 228 * 1024,
              "ids kernel: its blocks an SM fit in shared memory");

__device__ __forceinline__ u64 fmix64(u64 k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdull;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ull;
  k ^= k >> 33;
  return k;
}

// The global table's side: where a launch sends rows.
struct Sink {
  Slot* table;
  u64 mask;
  u64 max_probe;
  Slot* spill;  // null: a row with no slot sets the overflow flag
  u64 spill_cap;
  u64* state;
};

// Adds w to key's count in the global table, claiming a free slot for a
// new key, within max_probe slots from `slot`, whose key word a load has
// read as `cur`; else appends (key, w) to the spill buffer. A key slot
// goes from EMPTY to its key once and never changes after, so a read that
// finds a key is current; one that finds EMPTY is settled by the CAS.
// `claims` counts this thread's new keys.
__device__ __forceinline__ void send_from(const Sink& s, u64 key, u64 w,
                                          u64 slot, u64 cur,
                                          unsigned& claims) {
  for (u64 probe = 0; probe < s.max_probe; ++probe) {
    u64* k = &s.table[slot].key;
    if (probe) cur = __ldcg(k);
    if (cur == kEmpty) {
      cur = atomicCAS(k, kEmpty, key);
      if (cur == kEmpty) {
        ++claims;
        atomicAdd(&s.table[slot].count, w);
        return;
      }
    }
    if (cur == key) {
      atomicAdd(&s.table[slot].count, w);
      return;
    }
    slot = (slot + 1) & s.mask;
  }
  if (s.spill != nullptr) {
    const u64 j = atomicAdd(&s.state[kSpilled], 1ull);
    if (j < s.spill_cap) {
      s.spill[j].key = key;
      s.spill[j].count = w;
      return;
    }
  }
  s.state[kOverflow] = 1;  // the row is lost: the host raises
}

__device__ __forceinline__ void send(const Sink& s, u64 key, u64 w,
                                     unsigned& claims) {
  const u64 slot = fmix64(key) & s.mask;
  send_from(s, key, w, slot, __ldcg(&s.table[slot].key), claims);
}

// Adds w to key's count in the block's shared table: 1 if it claimed a
// slot, 0 if it found its key, -1 if no slot was found within
// kSharedProbe slots (the table is full there). The slot hash is two
// 32-bit products of the ids, cheaper than fmix64.
__device__ __forceinline__ int shared_add(u64* skey, unsigned* scnt,
                                          u64 key, unsigned w) {
  const unsigned h = (unsigned)(key >> 32) * 0x9e3779b1u +
                     (unsigned)key * 0x85ebca77u;
  unsigned slot = (h ^ (h >> 16)) & (kShared - 1);
  for (int probe = 0; probe < kSharedProbe; ++probe) {
    u64 cur = ((volatile u64*)skey)[slot];
    if (cur == kEmpty) {
      cur = atomicCAS(&skey[slot], kEmpty, key);
      if (cur == kEmpty) {
        atomicAdd(&scnt[slot], w);
        return 1;
      }
    }
    if (cur == key) {
      atomicAdd(&scnt[slot], w);
      return 0;
    }
    slot = (slot + 1) & (kShared - 1);
  }
  return -1;
}

// Sends every row of the block's shared table to the global table and
// clears it, kBatch rows of a thread at a time: their first slots' keys
// are loaded together, so a thread waits on one L2 round trip a batch,
// not one a row. Called by the whole block.
__device__ __forceinline__ void flush(const Sink& s, u64* skey,
                                      unsigned* scnt, int* claimed,
                                      unsigned& claims, unsigned& sent) {
  static_assert(kShared % (kBatch * kThreads) == 0, "flush batches");
  for (int i0 = threadIdx.x; i0 < kShared; i0 += kBatch * kThreads) {
    u64 key[kBatch], slot[kBatch], cur[kBatch];
    unsigned cnt[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      key[u] = skey[i];
      cnt[u] = scnt[i];
      skey[i] = kEmpty;
      scnt[i] = 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      slot[u] = fmix64(key[u]) & s.mask;
      if (key[u] != kEmpty) cur[u] = __ldcg(&s.table[slot[u]].key);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (key[u] != kEmpty) {
        send_from(s, key[u], cnt[u], slot[u], cur[u], claims);
        ++sent;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) *claimed = 0;
}

// Adds each thread's counter v to state[at], one atomic a block (every
// thread of the block must call it; `acc` a shared word, 0 on entry and
// left 0).
__device__ __forceinline__ void add_state(u64* state, int at, unsigned v,
                                          unsigned* acc) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(acc, v);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (*acc) atomicAdd(&state[at], (u64)*acc);
    *acc = 0;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
insert_ids_kernel(const int32_t* __restrict__ flat,
                  const int32_t* __restrict__ incl, int n, unsigned V,
                  Sink s, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* skey = (u64*)smem;
  unsigned* scnt = (unsigned*)(skey + kShared);
  int* sids = (int*)(scnt + kShared);
  unsigned* sbits = (unsigned*)(sids + kTile + 4);
  __shared__ int claimed;
  __shared__ int first_span;
  __shared__ unsigned acc;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long total = incl[n - 1];
  long long per = (total + gridDim.x - 1) / gridDim.x;
  per = (per + 3) & ~3ll;  // 16-byte aligned ranges
  const long long r0 = (long long)blockIdx.x * per;
  const long long r1 = r0 + per < total ? r0 + per : total;
  if (r0 >= r1) return;  // the whole block: no barrier is left waiting

  for (int i = tid; i < kShared; i += kThreads) {
    skey[i] = kEmpty;
    scnt[i] = 0;
  }
  if (tid == 0) {
    claimed = 0;
    acc = 0;
    int lo = 0, hi = n - 1;  // the first k with incl[k] > r0 (incl[n-1] > r0)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (incl[mid] > r0)
        hi = mid;
      else
        lo = mid + 1;
    }
    first_span = lo;
  }
  __syncthreads();
  long long k = first_span;  // every thread walks incl alike
  unsigned claims = 0, sent = 0;
  bool bad = false;

  for (long long t0 = r0; t0 < r1; t0 += kTile) {
    const int len = (int)(r1 - t0 < kTile ? r1 - t0 : kTile);
    const int staged = len + (t0 + len < total ? 1 : 0);  // + the next id
    int j0 = 0;
    if (vec) {
      const int4* src = (const int4*)(flat + t0);
      for (int q = tid; q < (len >> 2); q += kThreads)
        ((int4*)sids)[q] = __ldg(src + q);
      j0 = len & ~3;
    }
    for (int j = j0 + tid; j < staged; j += kThreads) sids[j] = flat[t0 + j];
    for (int w = tid; w < kTile / 32; w += kThreads) sbits[w] = 0;
    __syncthreads();
    // The spans ending in this tile: incl[k..] <= t0 + len, read a block
    // of spans at a time (incl does not fall, so they are a prefix).
    for (;;) {
      const long long at = k + tid;
      bool in = false;
      if (at < n) {
        const long long e = incl[at];
        in = e <= t0 + len;
        if (in && e > t0) {
          const int j = (int)(e - 1 - t0);
          atomicOr(&sbits[j >> 5], 1u << (j & 31));
        }
      }
      const int cnt = __syncthreads_count(in);
      k += cnt;
      if (cnt < kThreads) break;
    }
    // The tile's pairs, a token a thread.
    for (int base = 0; base < len; base += kThreads) {
      const int j = base + tid;
      u64 key = kEmpty;
      bool live = false;
      if (j < len) {
        const unsigned a = (unsigned)sids[j];
        bad |= a >= V;
        const bool last = (sbits[j >> 5] >> (j & 31)) & 1u;
        if (!last && t0 + j + 1 < total) {
          key = ((u64)a << 32) | (unsigned)sids[j + 1];
          live = key != kEmpty;
        }
      }
      const unsigned w = 1;
      const int r = live ? shared_add(skey, scnt, key, w) : 0;
      if (r < 0) {
        send(s, key, w, claims);
        ++sent;
      }
      // The block's claimed slots, one shared atomic a warp.
      const unsigned fresh = __ballot_sync(0xffffffffu, r > 0);
      if (lane == 0 && fresh) atomicAdd(&claimed, __popc(fresh));
    }
    __syncthreads();
    if (claimed > kShared / 2) flush(s, skey, scnt, &claimed, claims, sent);
  }
  flush(s, skey, scnt, &claimed, claims, sent);
  if (__syncthreads_or(bad) && tid == 0) s.state[kMismatch] = 1;
  add_state(s.state, kDistinct, claims, &acc);
  add_state(s.state, kSent, sent, &acc);
}

__global__ void insert_weighted_kernel(const u64* __restrict__ in_keys,
                                       const u64* __restrict__ in_counts,
                                       long long m, long long stride,
                                       u64 bias, Sink s) {
  __shared__ unsigned acc;
  if (threadIdx.x == 0) acc = 0;
  __syncthreads();
  unsigned claims = 0, sent = 0;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < m; i += step) {
    const u64 key = in_keys[i * stride];
    if (key != kEmpty) {
      send(s, key, in_counts[i * stride] + bias, claims);
      ++sent;
    }
  }
  add_state(s.state, kDistinct, claims, &acc);
  add_state(s.state, kSent, sent, &acc);
}

// The used slots of kRowThreads * kCompactPer slots a block, written from
// the block's place, one cursor atomic a block; a count word holds count -
// 1.
__global__ void compact_kernel(const Slot* __restrict__ table,
                               long long slots, u64* out_keys,
                               u64* out_counts, u64 out_cap, u64* cursor) {
  __shared__ unsigned warp_sum[kRowThreads / 32];
  __shared__ unsigned long long base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = (long long)blockIdx.x * kRowThreads * kCompactPer;
  ulonglong2 v[kCompactPer];
  unsigned used = 0;
#pragma unroll
  for (int u = 0; u < kCompactPer; ++u) {
    const long long i = first + (long long)u * kRowThreads + threadIdx.x;
    v[u] = i < slots ? __ldcs((const ulonglong2*)(table + i))
                     : make_ulonglong2(kEmpty, kEmpty);
    used += v[u].x != kEmpty;
  }
  // The thread's place: an inclusive scan over the warp, then the warps'.
  unsigned incl = used;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
    for (int w = 0; w < kRowThreads / 32; ++w) {
      const unsigned c = warp_sum[w];
      warp_sum[w] = total;
      total += c;
    }
    base = total ? atomicAdd(cursor, (u64)total) : 0;
  }
  __syncthreads();
  u64 j = base + warp_sum[warp] + incl - used;
#pragma unroll
  for (int u = 0; u < kCompactPer; ++u) {
    if (v[u].x != kEmpty) {
      if (j < out_cap) {
        out_keys[j] = v[u].x;
        out_counts[j] = v[u].y + 1;
      }
      ++j;
    }
  }
}

int row_grid(long long work) {
  const long long blocks = (work + kRowThreads - 1) / kRowThreads;
  return (int)(blocks < 1 ? 1 : blocks > kMaxRowBlocks ? kMaxRowBlocks
                                                       : blocks);
}

bool bad_slots(long long slots) {
  return slots <= 0 || (slots & (slots - 1)) != 0;
}

Sink sink(void* table, long long slots, u64* state, void* spill,
          long long spill_cap, long long max_probe) {
  return Sink{(Slot*)table, (u64)(slots - 1), (u64)max_probe, (Slot*)spill,
              (u64)(spill_cap < 0 ? 0 : spill_cap), state};
}

// The ids kernel's grid: its blocks resident on the card at once, set up
// once a device (the shared memory above 48 KB must be asked for).
constexpr int kMaxDevices = 64;

int ids_blocks() {
  static int blocks[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return -1;
  if (blocks[dev] > 0) return blocks[dev];
  int sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(insert_ids_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmemBytes) != cudaSuccess ||
      cudaFuncSetAttribute(insert_ids_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, insert_ids_kernel, kThreads, kSmemBytes) != cudaSuccess ||
      per_sm < 1)
    return -1;
  blocks[dev] = sms * per_sm;
  return blocks[dev];
}

}  // namespace

// Inserts the adjacent pairs of n spans' ids: flat (>= max_tokens,) int32,
// incl (n,) int32 inclusive offsets, max_tokens a bound of incl[n - 1] (the
// grid's size); table (slots,) 16-byte slots, spill (spill_cap,) slots
// (spill_cap >= the pairs the launch can send), max_probe a global probe's
// cap. Returns cudaGetLastError() after the launch.
extern "C" int tgx_pair_insert_ids(const int32_t* flat, const int32_t* incl,
                                   int n, unsigned V, void* table,
                                   long long slots, u64* state, void* spill,
                                   long long spill_cap, long long max_probe,
                                   long long max_tokens, void* stream) {
  if (n < 1 || bad_slots(slots) || max_probe < 1)
    return (int)cudaErrorInvalidValue;
  if (max_tokens < 1) return (int)cudaSuccess;
  const int resident = ids_blocks();
  if (resident < 1) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
  }
  const long long tiles = (max_tokens + kTile - 1) / kTile;
  const int grid = (int)(tiles < resident ? tiles : resident);
  const int vec = ((uintptr_t)flat & 15) == 0;
  insert_ids_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      flat, incl, n, V, sink(table, slots, state, spill, spill_cap,
                             max_probe), vec);
  return (int)cudaGetLastError();
}

// Adds m (key, count + bias) rows (row i at in_keys[i * stride],
// in_counts[i * stride]), skipping EMPTY keys.
extern "C" int tgx_pair_insert_weighted(const u64* in_keys,
                                        const u64* in_counts, long long m,
                                        long long stride, long long bias,
                                        void* table, long long slots,
                                        u64* state, void* spill,
                                        long long spill_cap,
                                        long long max_probe, void* stream) {
  if (m < 0 || stride < 1 || bad_slots(slots) || max_probe < 1)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  insert_weighted_kernel<<<row_grid(m), kRowThreads, 0,
                           (cudaStream_t)stream>>>(
      in_keys, in_counts, m, stride, (u64)bias,
      sink(table, slots, state, spill, spill_cap, max_probe));
  return (int)cudaGetLastError();
}

// Writes the used slots' (key, count) to out_keys / out_counts (out_cap
// rows each) from state's cursor on (the caller zeroes it) and advances
// the cursor past them.
extern "C" int tgx_pair_compact(const void* table, long long slots,
                                u64* out_keys, u64* out_counts,
                                long long out_cap, u64* state,
                                void* stream) {
  if (bad_slots(slots) || out_cap < 0) return (int)cudaErrorInvalidValue;
  const long long per = (long long)kRowThreads * kCompactPer;
  compact_kernel<<<(int)((slots + per - 1) / per), kRowThreads, 0,
                   (cudaStream_t)stream>>>((const Slot*)table, slots,
                                           out_keys, out_counts,
                                           (u64)out_cap, state + kCursor);
  return (int)cudaGetLastError();
}
