// The first design of tokengeex_tpu_torch/csrc/dfa_mask.cu, kept to be
// timed beside the package's kernel by experiments/torch_dfa_design.py;
// the package does not build it.
//
// One thread per (row, start position); a block of 1024 threads takes a
// tile of 1024 consecutive positions of the flattened (B, W8) bytes,
// staged with an L-byte halo in shared memory, and walks up to L DFA
// steps from each start in registers, stopping at the dead state 0.
// Blocks are persistent (as many as fit the card), so the full (S, 256)
// transition table is staged into shared memory once per block, as
// uint16 ("shared" route, table = 1); otherwise every step reads the
// int32 table from global memory (table = 2); table = 0 walks no DFA.
// `store` = 0 drops the mask's global stores (the ballots still run), to
// split the kernel's time. Entry `tgx_dfa_mask_first`: the package's
// first C interface plus `store`. The mask and the coin are the
// package's (csrc/dfa_mask.cu).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxLen = 64;

__device__ __forceinline__ uint32_t tgx_mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool char_start(uint8_t c) {
  return (c & 0xC0) != 0x80;
}

// TABLE: 0 no DFA (every candidate allowed), 1 shared uint16 table,
// 2 global int32 table.
template <int TABLE, bool STORE>
__global__ void __launch_bounds__(kThreads, 1)
dfa_mask_kernel(const uint8_t* __restrict__ bytes,
                const int* __restrict__ lens,
                const int* __restrict__ next_flat,
                const uint8_t* __restrict__ accept, uint32_t* __restrict__ out,
                int B, int W8, int L, int S, int start, uint32_t k0,
                int sample_base, unsigned long long thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* s_next = reinterpret_cast<uint16_t*>(smem);
  const int table_bytes = TABLE == 1 ? S * 256 * 2 : 0;
  uint8_t* s_accept = smem + table_bytes;
  const int accept_bytes = TABLE == 1 ? ((S + 15) / 16) * 16 : 0;
  uint8_t* s_bytes = smem + table_bytes + accept_bytes;

  if (TABLE == 1) {
    for (int i = threadIdx.x; i < S * 256; i += kThreads)
      s_next[i] = static_cast<uint16_t>(next_flat[i]);
    for (int i = threadIdx.x; i < S; i += kThreads) s_accept[i] = accept[i];
  }

  const long long total = static_cast<long long>(B) * W8;
  const long long n_tiles = (total + kThreads - 1) / kThreads;
  const int words = W8 >> 5;
  const int lane = threadIdx.x & 31;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long f0 = tile * kThreads;
    __syncthreads();  // the previous tile's bytes are no longer read
    for (int i = threadIdx.x; i < kThreads + L; i += kThreads) {
      const long long f = f0 + i;
      s_bytes[i] = f < total ? bytes[f] : 0;
    }
    __syncthreads();

    const long long f = f0 + threadIdx.x;
    const bool in_grid = f < total;
    const int b = in_grid ? static_cast<int>(f / W8) : 0;
    const int p = in_grid ? static_cast<int>(f - static_cast<long long>(b) * W8)
                          : 0;
    const int len = in_grid ? lens[b] : 0;
    unsigned long long bits = 0;
    if (p < len && char_start(s_bytes[threadIdx.x])) {
      const uint32_t k2 = tgx_mix32(
          tgx_mix32(k0 ^ static_cast<uint32_t>(sample_base + b)) ^
          static_cast<uint32_t>(p));
      const int lmax = min(L, len - p);
      int state = start;
      for (int l = 1; l <= lmax; ++l) {
        uint8_t acc = 1;
        if (TABLE != 0) {
          const int c = s_bytes[threadIdx.x + l - 1];
          state = TABLE == 1 ? static_cast<int>(s_next[state * 256 + c])
                             : __ldg(next_flat + state * 256 + c);
          if (state == 0) break;  // dead: absorbing, never accepts
          acc = TABLE == 1 ? s_accept[state] : __ldg(accept + state);
        }
        // p + l < len <= W8: byte p + l lies in this row and the halo.
        const bool end_ok = p + l == len ||
                            char_start(s_bytes[threadIdx.x + l]);
        if (acc && end_ok &&
            static_cast<unsigned long long>(
                tgx_mix32(k2 ^ static_cast<uint32_t>(l))) < thr)
          bits |= 1ull << (l - 1);
      }
    }
    // W8 is a multiple of 32, so a warp's 32 positions share a row.
    const int word = p >> 5;
    for (int l = 0; l < L; ++l) {
      const uint32_t w = __ballot_sync(0xFFFFFFFFu, (bits >> l) & 1ull);
      if (STORE && lane == 0 && in_grid)
        out[(static_cast<long long>(b) * L + l) * words + word] = w;
    }
  }
}

template <int TABLE, bool STORE>
int launch(const uint8_t* bytes, const int* lens, const int* next_flat,
           const uint8_t* accept, uint32_t* out, int B, int W8, int L, int S,
           int start, uint32_t k0, int sample_base, unsigned long long thr,
           size_t smem, cudaStream_t stream) {
  auto kernel = dfa_mask_kernel<TABLE, STORE>;
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
  const long long n_tiles =
      (static_cast<long long>(B) * W8 + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(
      n_tiles < static_cast<long long>(sms) * per_sm
          ? n_tiles : static_cast<long long>(sms) * per_sm);
  kernel<<<grid, kThreads, smem, stream>>>(bytes, lens, next_flat, accept,
                                           out, B, W8, L, S, start, k0,
                                           sample_base, thr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: 0 no DFA, 1 shared uint16 table, 2 global int32 table; store:
// 0 drops the mask's stores. Returns a CUDA error code (0 = launched).
extern "C" int tgx_dfa_mask_first(const void* bytes, const void* lens,
                                  const void* next_flat, const void* accept,
                                  void* out, int B, int W8, int L, int S,
                                  int start, int table, unsigned k0,
                                  int sample_base, long long thr, int store,
                                  void* stream) {
  if (B <= 0 || W8 <= 0 || (W8 & 31) != 0 || L < 1 || L > kMaxLen ||
      table < 0 || table > 2 || (table == 1 && (S < 1 || S > 65536)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* b8 = static_cast<const uint8_t*>(bytes);
  const auto* ln = static_cast<const int*>(lens);
  const auto* nf = static_cast<const int*>(next_flat);
  const auto* ac = static_cast<const uint8_t*>(accept);
  auto* o = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const auto t = static_cast<unsigned long long>(thr);
  const size_t tile = ((kThreads + kMaxLen + 15) / 16) * 16;
  const size_t smem = table == 1 ? static_cast<size_t>(S) * 512 +
                                       ((S + 15) / 16) * 16 + tile
                                 : tile;
#define TGX_FIRST(T)                                                        \
  return store ? launch<T, true>(b8, ln, nf, ac, o, B, W8, L, S, start, k0, \
                                 sample_base, t, smem, st)                  \
               : launch<T, false>(b8, ln, nf, ac, o, B, W8, L, S, start,    \
                                  k0, sample_base, t, smem, st)
  if (table == 1) TGX_FIRST(1);
  if (table == 2) TGX_FIRST(2);
  TGX_FIRST(0);
#undef TGX_FIRST
}
