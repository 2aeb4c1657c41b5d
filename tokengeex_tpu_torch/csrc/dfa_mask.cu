// The generate feed's candidate mask on Hopper (sm_90a).
//
// Replaces the XLA program tokengeex_tpu/ops/dfa_device.py:75
// `candidate_mask_device` with its bit-pack `_packed_mask_fn` (:131). For
// every (row b, start p, length l <= L) the bit is set when
//   p < len[b], byte p starts a UTF-8 char,
//   p + l == len[b], or p + l < len[b] and byte p + l starts a char,
//   the allow DFA accepts bytes[p, p + l) (every candidate when there is
//   no DFA), and
//   the insert coin of (seed, sample_base + b, p, l) is below `thr`.
// Output (B, L, W8 / 8) bytes, bit i of byte j = position 8 j + i, written
// as 32-bit words: a warp's ballot over 32 consecutive positions.
//
// The DFA comes as a byte-class table (ops/dfa_device.py `DeviceDFA`):
// bytes whose columns of the transition table are equal share a class,
// and the (S, C) table holds the next state by (state, class), as uint8
// when S <= 256, else uint16. The 245-state DFA of all 37 named patterns
// has 68 classes: 16,660 bytes against 125,440 for the (S, 256) uint16
// table of the first design (experiments/torch_dfa_first.cu).
//
// Design: blocks of 128 threads, several to an SM, persistent (as many as
// fit the card), each staging the class table into shared memory once
// ("shared" route) or reading it from global memory, where it stays in
// L2 ("global" route, for class tables that do not fit); the wrapper
// picks the route by size. A block takes tiles of 1,024 positions of one
// row (tiles are aligned to rows, so indices stay 32-bit and a row's last
// tile may be shorter). Per tile:
//   - every thread holds 8 of the tile's bytes (16 threads also 4 of its
//     64-byte halo) in registers, loaded while the previous tile walked,
//     and writes their classes and char-start flags to shared memory;
//     one thread the row's length;
//   - warp w owns the tile's positions [256 w, 256 w + 256) and their
//     mask words. Its first step is dense: lane j walks positions 256 w +
//     32 i + j, i < 8, so length 1's words are ballots; the walks still
//     alive go to a list in shared memory, and every later step walks only
//     the warp's list, 32 entries at a time, setting the mask bits of its
//     length with shared atomics and appending the walks still alive to
//     the next step's list (a ballot and a popcount, no atomics). A walk
//     stops at the dead state 0 (absorbing, never accepting); on code most
//     walks die within two or three steps, so a step costs what its live
//     walks need. The lists are the warp's own, so steps need no barrier
//     and the warps of a block walk independently. A warp owning 256
//     positions walks denser lists than one owning 128 (blocks of 256
//     threads) and keeps more warps an SM than one owning 512
//     (experiments/torch_dfa_design.py SHAPES); a walk of 4 starts a
//     thread to the end of the warp's longest was issue bound, and
//     block-wide lists with a barrier a step latency bound (PERF.md);
//   - the tile's L x 32 mask words are staged in shared memory, then each
//     length's words are written as one contiguous 128-byte run.
// Two barriers a tile.
//
// Bound on this card: the bytes are read once (B W8) and the mask written
// once (B L W8 / 8), ~25 MB for an 8 MiB group at L = 16 (~7.6 us at
// 3.35 TB/s); the table lookups (~2 a start on code under the 37-pattern
// DFA, the walks die early) take ~2 us at the shared-memory rate.
//
// The coin is counter-based, with uint32 wrapping products and logical
// shifts (tgx_mix32 is a bijection of 32 bits):
//   k0 = mix(seed ^ 0x9E3779B9), k1 = mix(k0 ^ sample), k2 = mix(k1 ^ p),
//   coin = mix(k2 ^ l); kept when coin < thr (thr = 2^32 keeps every one).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStarts = 8;                  // starts a thread walks
constexpr int kTile = kThreads * kStarts;   // positions a tile
constexpr int kMaxLen = 64;
constexpr int kTileBytes = kTile + kMaxLen;  // the tile and its halo
constexpr int kWarpSpan = 32 * kStarts;     // positions a warp owns
constexpr int kWords = kTile / (4 * kThreads);  // tile words a thread holds
static_assert(kWords >= 1 && kTile % (4 * kThreads) == 0,
              "each thread stages whole words of the tile");
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr uint32_t kStartBit = 0x100u;      // char start, beside the class

__host__ __device__ constexpr size_t pad16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Shared memory of a block, in this order: the class table and accept
// flags (shared route only), the byte -> class map, the tile's (class |
// char start << 8) halfwords, the tile's mask words, each warp's two
// lists of live walks, the row length.
// ops/dfa_device.py `shared_table_bytes` mirrors it (shared route).
struct Layout {
  size_t accept, cls, tile, out, list, len, total;
};

__host__ __device__ Layout layout(int S, int C, int esize, int L,
                                  bool shared) {
  Layout o;
  size_t at = shared ? pad16(static_cast<size_t>(S) * C * esize) : 0;
  o.accept = at;
  at += shared ? pad16(S) : 0;
  o.cls = at;
  at += 256;
  o.tile = at;
  at += 2 * kTileBytes;
  o.out = at;
  at += static_cast<size_t>(L) * 32 * 4;
  o.list = at;
  at += 2 * kTile * 4;
  o.len = at;
  o.total = at + 16;
  return o;
}

__device__ __forceinline__ uint32_t tgx_mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The insert coin of (row key k1, start p, length l) against thr.
__device__ __forceinline__ bool keep(uint32_t k1, int p, int l,
                                     unsigned long long thr) {
  return thr > 0xFFFFFFFFull ||
         static_cast<unsigned long long>(tgx_mix32(
             tgx_mix32(k1 ^ static_cast<uint32_t>(p)) ^
             static_cast<uint32_t>(l))) < thr;
}

// Appends e to a warp's `list` of n entries where `take` holds; every
// lane of the warp calls it. Returns the new count (the same on every
// lane).
__device__ __forceinline__ int push(uint32_t* list, int n, bool take,
                                    uint32_t e, int lane) {
  const uint32_t m = __ballot_sync(kFull, take);
  if (take) list[n + __popc(m & ((1u << lane) - 1u))] = e;
  return n + __popc(m);
}

// A tile byte as the walk reads it: its class, and 0x100 where it starts
// a UTF-8 char.
__device__ __forceinline__ uint32_t tile_entry(uint32_t c,
                                               const uint8_t* cls,
                                               bool classes) {
  return ((c & 0xC0u) != 0x80u ? kStartBit : 0u) | (classes ? cls[c] : 0u);
}

// TABLE: 0 no DFA (every candidate allowed), 1 the class table in shared
// memory, 2 the class table read from global memory. E: the table's
// entries, uint8_t or uint16_t.
template <int TABLE, typename E>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
dfa_mask_kernel(const uint8_t* __restrict__ bytes,
                const int* __restrict__ lens,
                const uint8_t* __restrict__ byte_class,
                const E* __restrict__ table,
                const uint8_t* __restrict__ accept,
                uint32_t* __restrict__ out, int B, int W8, int L, int S,
                int C, int start, uint32_t k0, int sample_base,
                unsigned long long thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(S, C, sizeof(E), L, TABLE == 1);
  const E* s_table = reinterpret_cast<const E*>(smem);
  uint8_t* s_accept = smem + lay.accept;
  uint8_t* s_cls = smem + lay.cls;
  uint16_t* s_tile = reinterpret_cast<uint16_t*>(smem + lay.tile);
  uint32_t* s_out = reinterpret_cast<uint32_t*>(smem + lay.out);
  uint32_t* s_list = reinterpret_cast<uint32_t*>(smem + lay.list);
  int* s_len = reinterpret_cast<int*>(smem + lay.len);
  const int tid = threadIdx.x;

  if (TABLE == 1) {
    // The table once per block, 16 B a load, then its tail.
    const int n = S * C * static_cast<int>(sizeof(E));
    const uint4* src = reinterpret_cast<const uint4*>(table);
    for (int i = tid; i < n / 16; i += kThreads)
      reinterpret_cast<uint4*>(smem)[i] = src[i];
    const uint8_t* tail = reinterpret_cast<const uint8_t*>(table);
    for (int i = (n & ~15) + tid; i < n; i += kThreads) smem[i] = tail[i];
    for (int i = tid; i < S; i += kThreads) s_accept[i] = accept[i];
  }
  if (TABLE != 0)
    for (int i = tid; i < 256; i += kThreads) s_cls[i] = byte_class[i];
  __syncthreads();

  const int per_row = (W8 + kTile - 1) / kTile;
  const int n_tiles = B * per_row;
  const int words = W8 >> 5;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // The next tile's bytes (kWords words of 4 a thread, and 4 of the halo
  // on the first 16 threads; zeros past the row) and the row length
  // (thread 0), loaded ahead of their use.
  uint32_t pre[kWords], pre_halo = 0u;
  int pre_len = 0;
  auto word_at = [&](int b, int pos) -> uint32_t {
    return pos < W8 ? *reinterpret_cast<const uint32_t*>(
                          bytes + static_cast<size_t>(b) * W8 + pos)
                    : 0u;  // W8 % 32 == 0: all 4 in the row or none
  };
  auto fetch = [&](int tile) {
    const int b = tile / per_row;
    const int t0 = (tile - b * per_row) * kTile;
#pragma unroll
    for (int w = 0; w < kWords; ++w)
      pre[w] = word_at(b, t0 + 4 * (tid + w * kThreads));
    if (tid < kMaxLen / 4) pre_halo = word_at(b, t0 + kTile + 4 * tid);
    if (tid == 0) pre_len = lens[b];
  };
  if (static_cast<int>(blockIdx.x) < n_tiles) fetch(blockIdx.x);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / per_row;
    const int t0 = (tile - b * per_row) * kTile;
    const int tlen = min(kTile, W8 - t0);  // a multiple of 32
    {
      uint32_t* t32 = reinterpret_cast<uint32_t*>(s_tile);
      auto stage = [&](uint32_t w, int at) {  // bytes 2 at .. 2 at + 3
        t32[at] = tile_entry(w & 0xFFu, s_cls, TABLE != 0) |
                  tile_entry((w >> 8) & 0xFFu, s_cls, TABLE != 0) << 16;
        t32[at + 1] = tile_entry((w >> 16) & 0xFFu, s_cls, TABLE != 0) |
                      tile_entry(w >> 24, s_cls, TABLE != 0) << 16;
      };
#pragma unroll
      for (int w = 0; w < kWords; ++w)
        stage(pre[w], 2 * (tid + w * kThreads));
      if (tid < kMaxLen / 4) stage(pre_halo, 2 * (kTile / 4 + tid));
    }
    if (tid == 0) *s_len = pre_len;
    if (tile + static_cast<int>(gridDim.x) < n_tiles)
      fetch(tile + gridDim.x);  // lands while this tile walks
    __syncthreads();

    const int len = *s_len;
    const uint32_t k1 =
        tgx_mix32(k0 ^ static_cast<uint32_t>(sample_base + b));
    // This warp's lists, and its mask words of lengths >= 2, which the
    // steps set by atomics: cleared (the previous tile's stores ended
    // before the barrier above).
    uint32_t* list_a = s_list + warp * (2 * kWarpSpan);
    uint32_t* list_b = list_a + kWarpSpan;
    for (int i = lane; i < (L - 1) * kStarts; i += 32)
      s_out[(1 + i / kStarts) * 32 + warp * kStarts + i % kStarts] = 0u;

    // Step 1, dense. A list entry is (state << 10 | position in tile).
    int n = 0;  // walks in list_a, the same on every lane
#pragma unroll
    for (int i = 0; i < kStarts; ++i) {
      const int q = warp * kWarpSpan + 32 * i + lane;
      const int p = t0 + q;
      const uint32_t here = s_tile[q];
      int nx = 1;  // no DFA: every walk lives to its limit
      bool acc = true;
      if (TABLE != 0) {
        const int at = start * C + static_cast<int>(here & 0xFFu);
        nx = TABLE == 1 ? static_cast<int>(s_table[at])
                        : static_cast<int>(__ldg(table + at));
        acc = (TABLE == 1 ? s_accept[nx] : __ldg(accept + nx)) != 0;
      }
      const bool live = q < tlen && p < len && (here & kStartBit) && nx != 0;
      const bool set = live && acc &&
                       (p + 1 == len || (s_tile[q + 1] & kStartBit)) &&
                       keep(k1, p, 1, thr);
      const uint32_t w = __ballot_sync(kFull, set);
      if (lane == 0) s_out[warp * kStarts + i] = w;
      n = push(list_a, n, live && 1 < L && p + 1 < len,
               static_cast<uint32_t>(nx) << 10 | static_cast<uint32_t>(q),
               lane);
    }
    __syncwarp();

    // Steps 2.. over the warp's live walks, until none is left (a walk
    // goes on to step l + 1 only when l < L).
    for (int l = 2; n > 0; ++l) {
      int m = 0;
      for (int base = 0; base < n; base += 32) {
        const int k = base + lane;
        const uint32_t e = k < n ? list_a[k] : 0u;
        const int q = static_cast<int>(e & 1023u);
        const int p = t0 + q;
        int nx = 1;
        bool acc = true;
        if (TABLE != 0) {
          const int at = static_cast<int>(e >> 10) * C +
                         static_cast<int>(s_tile[q + l - 1] & 0xFFu);
          nx = TABLE == 1 ? static_cast<int>(s_table[at])
                          : static_cast<int>(__ldg(table + at));
          acc = (TABLE == 1 ? s_accept[nx] : __ldg(accept + nx)) != 0;
        }
        const bool live = k < n && nx != 0;
        // p + l < len <= W8: byte p + l lies in this row and the halo.
        if (live && acc &&
            (p + l == len || (s_tile[q + l] & kStartBit)) &&
            keep(k1, p, l, thr))
          atomicOr(s_out + (l - 1) * 32 + (q >> 5), 1u << (q & 31));
        m = push(list_b, m, live && l < L && p + l < len,
                 static_cast<uint32_t>(nx) << 10 | static_cast<uint32_t>(q),
                 lane);
      }
      __syncwarp();
      uint32_t* t = list_a;
      list_a = list_b;
      list_b = t;
      n = m;
    }
    __syncthreads();

    // Each length's words as one contiguous run.
    const int nw = tlen >> 5;
    uint32_t* o = out + static_cast<size_t>(b) * L * words + (t0 >> 5);
    for (int i = tid; i < L * nw; i += kThreads) {
      const int l = i / nw;
      const int k = i - l * nw;
      o[static_cast<size_t>(l) * words + k] = s_out[l * 32 + k];
    }
  }
}

template <int TABLE, typename E>
int launch(const uint8_t* bytes, const int* lens, const uint8_t* cls,
           const void* table, const uint8_t* accept, uint32_t* out, int B,
           int W8, int L, int S, int C, int start, uint32_t k0,
           int sample_base, unsigned long long thr, cudaStream_t stream) {
  auto kernel = dfa_mask_kernel<TABLE, E>;
  const size_t smem = layout(S, C, sizeof(E), L, TABLE == 1).total;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_tiles = B * ((W8 + kTile - 1) / kTile);
  const int grid = std::min(n_tiles, sms * per_sm);
  kernel<<<grid, kThreads, smem, stream>>>(
      bytes, lens, cls, static_cast<const E*>(table), accept, out, B, W8, L,
      S, C, start, k0, sample_base, thr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// route: 0 no DFA, 1 the class table in shared memory, 2 in global memory;
// esize: the table's entry bytes (1: uint8, S <= 256; 2: uint16). bytes
// (and, on the shared route, the table) must be 16-byte aligned. Returns a CUDA error code (0 = launched).
extern "C" int tgx_dfa_mask(const void* bytes, const void* lens,
                            const void* byte_class, const void* table,
                            const void* accept, void* out, int B, int W8,
                            int L, int S, int C, int start, int route,
                            int esize, unsigned k0, int sample_base,
                            long long thr, void* stream) {
  if (B <= 0 || W8 <= 0 || (W8 & 31) != 0 || L < 1 || L > kMaxLen ||
      route < 0 || route > 2 ||
      static_cast<long long>(B) * W8 > INT_MAX ||
      (reinterpret_cast<uintptr_t>(bytes) & 15) != 0 ||
      (route == 1 && (reinterpret_cast<uintptr_t>(table) & 15) != 0) ||
      (route != 0 &&
       (S < 1 || C < 1 || C > 256 || start < 0 || start >= S ||
        (esize == 1 && S > 256) || (esize == 2 && S > 65536) ||
        (esize != 1 && esize != 2))))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* b8 = static_cast<const uint8_t*>(bytes);
  const auto* ln = static_cast<const int*>(lens);
  const auto* cl = static_cast<const uint8_t*>(byte_class);
  const auto* ac = static_cast<const uint8_t*>(accept);
  auto* o = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const auto t = static_cast<unsigned long long>(thr);
#define TGX_MASK(R, E)                                                     \
  return launch<R, E>(b8, ln, cl, table, ac, o, B, W8, L, S, C, start, k0, \
                      sample_base, t, st)
  if (route == 0) TGX_MASK(0, uint8_t);
  if (route == 1 && esize == 1) TGX_MASK(1, uint8_t);
  if (route == 1) TGX_MASK(1, uint16_t);
  if (esize == 1) TGX_MASK(2, uint8_t);
  TGX_MASK(2, uint16_t);
#undef TGX_MASK
}
