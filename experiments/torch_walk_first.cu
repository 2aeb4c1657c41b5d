// Viterbi backpointer walk with the exact-probe id lookup, for Hopper
// (sm_90a).
//
// Replaces: tokengeex_tpu/ops/lattice_jax.py `_viterbi_freq_impl` (an XLA
// program: a descending scan over the backpointers, two exact-table row
// gathers per on-path position, an int32 scatter-add), entered through
// `viterbi_freq`; and, for encode, the threaded native backtrack the JAX
// package calls there (`_native_flat_backtrack`).
//
// What it computes, per span (row, s, e) of whole, non-empty, reachable
// samples: from q = e, step back q <- q - best_l[q - 1] while q > s; each
// step is the token [q - l, q). Its id comes from the exact tables:
//   fp  = (P[q] - P[q - l]) * Rinv[q - l]        (both hash streams, mod 2^32)
//   i1  = ((fp1 ^ l * IDX_A1) * IDX_M1) >>> (32 - bits), i2 the same on fp2
//   id  = T1[i1] when its fp1, fp2 and length (word 2 >>> 24) all match,
//         else T2[i2] when they match there, else V (no token: a mismatch).
// Two outputs from one body:
//   - counts (V + 1,) int32: every token adds one to its id's bin (bin V
//     counts mismatches); integer atomics, so the counts are exact;
//   - ids (B, W) int32 and ntok (n,): a span's k-th token from its end
//     goes to cell e - 1 - k of its row, so its ids lie in position order
//     in [e - ntok, e), inside its own span; the caller compacts them.
// A span whose `ok` flag is 0 (unreachable end) is not walked (ntok 0).
//
// What bounds it on the H100: latency. The walk is a chain of dependent
// loads, ~2-3 k per 8 KB sample; from device memory each costs ~600 ns.
// The id lookups are independent: two 16-byte row gathers and six words
// per token, a few MB per row group.
//
// What the design does about it: one block per row. The block stages the
// row's backpointers (W bytes) into shared memory with coalesced loads,
// so each step of a walk is a shared-memory load (~30 cycles). One thread
// walks each span of the row (spans are disjoint) and records each
// token's end position in a shared (W,) uint16 array at the cell its id
// goes to; then all the block's threads resolve the recorded tokens in
// parallel, one cell each. Shared memory is 3 W bytes (24 KB at W = 8192),
// so several rows share an SM and their walks overlap.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tokengeex_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define TGX_WALK_THREADS 256
#define TGX_NO_TOKEN 0xFFFFu

// Index mixers of the two cuckoo tables (ops/hashing.py).
#define TGX_IDX_A1 0x27D4EB2Fu
#define TGX_IDX_M1 0x165667B1u
#define TGX_IDX_A2 0x9E3779B9u
#define TGX_IDX_M2 0xC2B2AE35u

struct WalkArgs {
  const void* bl;          // best_l, element (b, p) at b * bl_sr + p * bl_sp
  const int32_t* p1;       // (B, p_stride) prefix hashes, dp index p at pad+p
  const int32_t* p2;
  const int32_t* rinv1;    // (pad + W,) inverse powers, dp index p at pad + p
  const int32_t* rinv2;
  const int4* t1;          // (H, 4) exact rows [fp1, fp2, len << 24 | id, 0]
  const int4* t2;
  const int32_t* row_ptr;  // (B + 1,) spans of row b: order[row_ptr[b]..]
  const int32_t* order;    // (n,) span indices sorted by row
  const int32_t* sp_start; // (n,) dp index of each span's start
  const int32_t* sp_end;   // (n,) dp index of each span's end
  const uint8_t* ok;       // (n,) 0: do not walk
  int32_t* counts;         // (V + 1,) count mode, else null
  int32_t* ids;            // (B, W) ids mode, else null
  int32_t* ntok;           // (n,) ids mode, else null
  long long bl_sr, bl_sp;
  int W, p_stride, pad, bits, V;
};

template <typename BL>
__global__ void __launch_bounds__(TGX_WALK_THREADS)
viterbi_walk_kernel(const WalkArgs a) {
  const int b = blockIdx.x;
  const int s0 = a.row_ptr[b], s1 = a.row_ptr[b + 1];
  if (s0 == s1) return;
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* sbl = smem;
  uint16_t* tok = (uint16_t*)(smem + ((a.W + 15) & ~15));

  // Stage the row's backpointers; no token recorded yet.
  const BL* bl = (const BL*)a.bl + (long long)b * a.bl_sr;
  for (int p = threadIdx.x; p < a.W; p += blockDim.x) {
    sbl[p] = (uint8_t)bl[(long long)p * a.bl_sp];
    tok[p] = TGX_NO_TOKEN;
  }
  __syncthreads();

  // The walks: one thread per span of the row.
  for (int i = s0 + threadIdx.x; i < s1; i += blockDim.x) {
    const int k = a.order[i];
    // Clamped into [0, W], as the scans clamp their chains: the bounds are
    // checked on the CPU only, where a check costs no sync.
    const int e = min(max(a.sp_end[k], 0), a.W);
    const int s = min(max(a.sp_start[k], 0), e);
    int n = 0;
    if (a.ok[k]) {
      int q = e;
      while (q > s) {
        tok[e - 1 - n] = (uint16_t)(q - 1);
        const int l = sbl[q - 1];
        q -= l > 0 ? l : 1;
        ++n;
      }
    }
    if (a.ntok != nullptr) a.ntok[k] = n;
  }
  __syncthreads();

  // The ids: every recorded token, one cell per thread.
  const long long rowp = (long long)b * a.p_stride + a.pad;
  const int32_t* p1 = a.p1 + rowp;
  const int32_t* p2 = a.p2 + rowp;
  const int32_t* rinv1 = a.rinv1 + a.pad;
  const int32_t* rinv2 = a.rinv2 + a.pad;
  const unsigned shift = 32u - (unsigned)a.bits;
  for (int c = threadIdx.x; c < a.W; c += blockDim.x) {
    const unsigned pos = tok[c];
    if (pos == TGX_NO_TOKEN) continue;
    const unsigned l = sbl[pos] > 0 ? sbl[pos] : 1u;
    const int e = (int)pos + 1;
    const int st = e - (int)l;
    const uint32_t fp1 = ((uint32_t)__ldg(p1 + e) - (uint32_t)__ldg(p1 + st)) *
                         (uint32_t)__ldg(rinv1 + st);
    const uint32_t fp2 = ((uint32_t)__ldg(p2 + e) - (uint32_t)__ldg(p2 + st)) *
                         (uint32_t)__ldg(rinv2 + st);
    const uint32_t i1 = ((fp1 ^ (l * TGX_IDX_A1)) * TGX_IDX_M1) >> shift;
    const uint32_t i2 = ((fp2 ^ (l * TGX_IDX_A2)) * TGX_IDX_M2) >> shift;
    const int4 r1 = __ldg(a.t1 + i1);
    const int4 r2 = __ldg(a.t2 + i2);
    int id = a.V;
    if ((uint32_t)r1.x == fp1 && (uint32_t)r1.y == fp2 &&
        ((uint32_t)r1.z >> 24) == l) {
      id = r1.z & 0xFFFFFF;
    } else if ((uint32_t)r2.x == fp1 && (uint32_t)r2.y == fp2 &&
               ((uint32_t)r2.z >> 24) == l) {
      id = r2.z & 0xFFFFFF;
    }
    if (a.ids != nullptr) {
      a.ids[(long long)b * a.W + c] = id;
    } else {
      atomicAdd(a.counts + id, 1);
    }
  }
}

template <typename BL>
static int launch(const WalkArgs& a, int B, cudaStream_t stream) {
  const size_t smem = (size_t)((a.W + 15) & ~15) + 2 * (size_t)a.W;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_walk_kernel<BL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  viterbi_walk_kernel<BL><<<B, TGX_WALK_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Count mode when counts is not null, ids mode (ids and ntok) otherwise.
// best_l elements are bl_bytes wide (1: uint8, 4: int32), strides in
// elements; W < 65535 (token ends are kept as uint16). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int tgx_viterbi_walk(
    const void* bl, const int32_t* p1, const int32_t* p2,
    const int32_t* rinv1, const int32_t* rinv2, const int32_t* t1,
    const int32_t* t2, const int32_t* row_ptr, const int32_t* order,
    const int32_t* sp_start, const int32_t* sp_end, const uint8_t* ok,
    int32_t* counts, int32_t* ids, int32_t* ntok, long long bl_sr,
    long long bl_sp, int bl_bytes, int B, int W, int p_stride, int pad,
    int bits, int V, void* stream) {
  if (B < 1 || W < 1 || W >= (int)TGX_NO_TOKEN || bits < 1 || bits > 31 ||
      (bl_bytes != 1 && bl_bytes != 4) || ok == nullptr ||
      (counts == nullptr && (ids == nullptr || ntok == nullptr)))
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
  a.ids = counts == nullptr ? ids : nullptr;
  a.ntok = counts == nullptr ? ntok : nullptr;
  a.bl_sr = bl_sr;
  a.bl_sp = bl_sp;
  a.W = W;
  a.p_stride = p_stride;
  a.pad = pad;
  a.bits = bits;
  a.V = V;
  cudaStream_t s = (cudaStream_t)stream;
  return bl_bytes == 1 ? launch<uint8_t>(a, B, s) : launch<int32_t>(a, B, s);
}
