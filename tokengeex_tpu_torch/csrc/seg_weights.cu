// Segsum weights: exp of the true marginals and in-block prefix sums over
// the sorted-hit order, for Hopper (sm_90a).
//
// Replaces: tokengeex_tpu/ops/lattice_pallas_fused.py `seg_weights`
// (`_seg_weights_kernel`, `_lane_cumsum`), and the per-length gathers
// around it in tokengeex_tpu/ops/lattice_jax.py `_segsum_expected_impl`.
//
// What it computes, per block of 128 sorted hits (i = block * 128 + k):
//   ss[i] = sum_{k' <= k} d2[block * 128 + k']       (in-block, inclusive)
//   w[i]  = i < n_hit ? expf((r0[i] + r1[i]) + ss[i]) : 0
//   cf[i] = sum_{k' <= k} w[block * 128 + k']         (in-block, inclusive)
//   t[block] = cf[block * 128 + 127]
// r0 holds alpha - Z and r1 the beta of each hit, d2 the telescoping score
// differences with each block's anchor score at k = 0, so w is the hit's
// true marginal in [0, 1]. Both scans add in the Hillis-Steele order of the
// TPU kernel's `_lane_cumsum` (strides 1, 2, 4, ..., 64, each step adding
// the value `stride` places back, or 0 before the block start), so the
// plain version, which takes the same steps, rounds alike.
//
// Two ways in, one body:
//   - streams (`seg_weights`, one length): r0, r1 and d2 as (H,) arrays;
//   - gathers (`seg_weights_gather`, a row group's segsum in one launch):
//     every token length's hits laid end to end, length l0 holding the
//     blocks [boff[l0], boff[l0+1]) (each length's capacity is a multiple
//     of 128, so no block straddles two lengths). The kernel gathers its
//     own inputs at the hit's flat position pos = b * W + w:
//       r0 = col1[pos]                         (alpha - Z, (B, W))
//       r1 = w + l0 + 1 <= W ? bt[b, w + l0 + 1] : -inf
//            (the betas, (B, W + 1)), -inf where the token's dropout coin
//            from du[b, pad + w] drops it (l0 > 0)
//       d2 = k == 0 ? anchor[block] : d[i]
//     which are the streams the per-length torch code built, bit for bit.
//
// What bounds it on the H100: bytes. Streams: 12 bytes per hit in, 4 out,
// for one expf and 16 adds. Gathers: the hit's position, its difference
// and its output, 12 bytes per hit, and the (B, W) planes read once; the
// planes' gathers follow the sorted order, so they are scattered, but a
// row group's planes (16 MB each) stay in the 50 MB L2.
//
// What the design does about it: one warp per 128-hit block, 4 hits per
// lane at k = lane + 32 c, so every load and store of a column c is one
// coalesced 128-byte transaction. A scan step's neighbour `stride` places
// back is a warp shuffle (stride < 32, from column c or c - 1) or another
// register of the same lane (stride 32 or 64); nothing goes through shared
// or device memory between the loads and the stores. The gathers make one
// launch per row group of the 16 lengths' ~25 torch ops and one launch
// each, and keep the (B * W, 2) plane of every length out of memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tokengeex_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "scan_lanes.cuh"

#define TGX_SEG_BLK 128
#define TGX_WARPS 8  // warps (128-hit blocks) per thread block

// One Hillis-Steele step of stride S over the 128 values x[c] (k = lane +
// 32 c) held by one warp: x[k] += x[k - S], or += 0 before the block start.
template <int S>
__device__ __forceinline__ void scan_step(float (&x)[4], int lane) {
  float back[4];
  if (S < 32) {
    // k - S lies in column c when lane >= S, else at the same source lane
    // of column c - 1 (before the block for c = 0).
    const int src = (lane - S) & 31;
    float same[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) same[c] = __shfl_sync(0xffffffffu, x[c], src);
    back[0] = (lane >= S) ? same[0] : 0.0f;
#pragma unroll
    for (int c = 1; c < 4; ++c) back[c] = (lane >= S) ? same[c] : same[c - 1];
  } else {
    // S = 32 or 64: k - S is this lane's own value S / 32 columns back.
    constexpr int dc = S / 32;
#pragma unroll
    for (int c = 0; c < 4; ++c) back[c] = (c >= dc) ? x[c >= dc ? c - dc : 0] : 0.0f;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) x[c] = x[c] + back[c];
}

// In-block inclusive prefix sum of one warp's 128 values, in the order of
// `_lane_cumsum`: strides 1, 2, 4, ..., 64.
__device__ __forceinline__ void lane_cumsum(float (&x)[4], int lane) {
  scan_step<1>(x, lane);
  scan_step<2>(x, lane);
  scan_step<4>(x, lane);
  scan_step<8>(x, lane);
  scan_step<16>(x, lane);
  scan_step<32>(x, lane);
  scan_step<64>(x, lane);
}

struct SegArgs {
  // streams
  const float* r0;  // (H,)
  const float* r1;  // (H,)
  const float* d2;  // (H,)
  int n_hit;        // hits of the one length
  // gathers
  const int32_t* perm;    // (H,) flat hit positions b * W + w
  const float* col1;      // (B, W)
  const float* bt;        // (B, W + 1)
  const int32_t* du;      // (B, du_stride), DROP only
  const float* d;         // (H,) telescoping differences
  const float* anchor;    // (H / 128,) block anchors
  const int32_t* meta;    // (2L + 1,): boff[0..L] in blocks, n_hit[0..L-1]
  int L, W, BW, du_stride, pad;
  uint32_t thr_half;
  // out
  float* cf;  // (H,)
  float* t;   // (H / 128,)
  int nblk;
};

template <bool GATHER, bool DROP>
__global__ void seg_weights_kernel(const SegArgs p) {
  const int lane = threadIdx.x & 31;
  const int blk = blockIdx.x * TGX_WARPS + (threadIdx.x >> 5);
  if (blk >= p.nblk) return;  // whole warps leave together
  const size_t base = (size_t)blk * TGX_SEG_BLK;

  // The block's length and its hits: l0 counts the lengths that begin at
  // or before this block.
  int l0 = 0;
  int n_hit = p.n_hit;
  size_t first = 0;  // the length's first hit
  if constexpr (GATHER) {
    for (int l = 1; l < p.L; ++l) l0 += (blk >= p.meta[l]) ? 1 : 0;
    first = (size_t)p.meta[l0] * TGX_SEG_BLK;
    n_hit = p.meta[p.L + 1 + l0];
  }

  float x[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const size_t i = base + lane + 32 * c;
    if constexpr (GATHER)
      x[c] = (c == 0 && lane == 0) ? p.anchor[blk] : p.d[i];
    else
      x[c] = p.d2[i];
  }
  lane_cumsum(x, lane);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const size_t i = base + lane + 32 * c;
    float r0, r1;
    if constexpr (GATHER) {
      // Clamped, so that a bad position reads a wrong value, never
      // outside the planes.
      const uint32_t pos =
          (uint32_t)min(max(p.perm[i], 0), p.BW - 1);
      const uint32_t b = pos / (uint32_t)p.W;
      const uint32_t w = pos - b * (uint32_t)p.W;
      r0 = p.col1[pos];
      const uint32_t wi = w + (uint32_t)l0 + 1u;
      r1 = (wi <= (uint32_t)p.W) ? p.bt[(size_t)b * (p.W + 1) + wi]
                                 : -INFINITY;
      if constexpr (DROP) {
        const uint32_t u =
            (uint32_t)p.du[(size_t)b * p.du_stride + p.pad + w];
        r1 = tgx_dropped(u, l0, p.thr_half) ? -INFINITY : r1;
      }
    } else {
      r0 = p.r0[i];
      r1 = p.r1[i];
    }
    const float w = expf((r0 + r1) + x[c]);
    x[c] = (i - first < (size_t)n_hit) ? w : 0.0f;
  }
  lane_cumsum(x, lane);
#pragma unroll
  for (int c = 0; c < 4; ++c) p.cf[base + lane + 32 * c] = x[c];
  if (lane == 31) p.t[blk] = x[3];
}

template <bool GATHER, bool DROP>
static int launch(const SegArgs& args, cudaStream_t stream) {
  const int blocks = (args.nblk + TGX_WARPS - 1) / TGX_WARPS;
  seg_weights_kernel<GATHER, DROP>
      <<<blocks, 32 * TGX_WARPS, 0, stream>>>(args);
  return (int)cudaGetLastError();
}

// Streams of one length; H must be a multiple of 128. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int tgx_seg_weights(const float* r0, const float* r1, const float* d2,
                               float* cf, float* t, int H, int n_hit,
                               void* stream) {
  if (H % TGX_SEG_BLK != 0) return (int)cudaErrorInvalidValue;
  SegArgs args = {};
  args.r0 = r0;
  args.r1 = r1;
  args.d2 = d2;
  args.n_hit = n_hit;
  args.cf = cf;
  args.t = t;
  args.nblk = H / TGX_SEG_BLK;
  return launch<false, false>(args, (cudaStream_t)stream);
}

// Every length of a row group in one launch: H hits in L lengths as `meta`
// lays them out (H a multiple of 128, B * W < 2^31). du may be null when
// use_drop == 0. Returns cudaGetLastError() after the launch.
extern "C" int tgx_seg_weights_gather(const int32_t* perm, const float* col1,
                                      const float* bt, const int32_t* du,
                                      const float* d, const float* anchor,
                                      const int32_t* meta, float* cf, float* t,
                                      int H, int L, int W, int B,
                                      int du_stride, int pad,
                                      unsigned thr_half, int use_drop,
                                      void* stream) {
  if (H % TGX_SEG_BLK != 0 || L < 1 || W < 1 || B < 1 ||
      (long long)B * W >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  SegArgs args = {};
  args.perm = perm;
  args.col1 = col1;
  args.bt = bt;
  args.du = du;
  args.d = d;
  args.anchor = anchor;
  args.meta = meta;
  args.L = L;
  args.W = W;
  args.BW = B * W;
  args.du_stride = du_stride;
  args.pad = pad;
  args.thr_half = thr_half;
  args.cf = cf;
  args.t = t;
  args.nblk = H / TGX_SEG_BLK;
  cudaStream_t s = (cudaStream_t)stream;
  return use_drop ? launch<true, true>(args, s) : launch<true, false>(args, s);
}
