// Segsum weights: exp of the true marginals and in-block prefix sums over
// the sorted-hit order, for Hopper (sm_90a).
//
// Replaces: tokengeex_tpu/ops/lattice_pallas_fused.py `seg_weights`
// (`_seg_weights_kernel`, `_lane_cumsum`).
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
// What bounds it on the H100: bytes. It reads 12 bytes per hit (r0, r1, d2)
// and writes 4 (cf), for one expf and 16 adds.
//
// What the design does about it: one warp per 128-hit block, 4 hits per
// lane at k = lane + 32 c, so every load and store of a column c is one
// coalesced 128-byte transaction. A scan step's neighbour `stride` places
// back is a warp shuffle (stride < 32, from column c or c - 1) or another
// register of the same lane (stride 32 or 64); nothing goes through shared
// or device memory between the loads and the stores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tokengeex_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__global__ void seg_weights_kernel(const float* __restrict__ r0,  // (H,)
                                   const float* __restrict__ r1,  // (H,)
                                   const float* __restrict__ d2,  // (H,)
                                   float* __restrict__ cf,        // (H,)
                                   float* __restrict__ t,         // (H / 128,)
                                   int nblk, int n_hit) {
  const int lane = threadIdx.x & 31;
  const int blk = blockIdx.x * TGX_WARPS + (threadIdx.x >> 5);
  if (blk >= nblk) return;  // whole warps leave together
  const size_t base = (size_t)blk * TGX_SEG_BLK;

  float x[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) x[c] = d2[base + lane + 32 * c];
  lane_cumsum(x, lane);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const size_t i = base + lane + 32 * c;
    const float w = expf((r0[i] + r1[i]) + x[c]);
    x[c] = (i < (size_t)n_hit) ? w : 0.0f;
  }
  lane_cumsum(x, lane);
#pragma unroll
  for (int c = 0; c < 4; ++c) cf[base + lane + 32 * c] = x[c];
  if (lane == 31) t[blk] = x[3];
}

// H must be a multiple of 128. Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int tgx_seg_weights(const float* r0, const float* r1, const float* d2,
                               float* cf, float* t, int H, int n_hit,
                               void* stream) {
  if (H % TGX_SEG_BLK != 0) return (int)cudaErrorInvalidValue;
  const int nblk = H / TGX_SEG_BLK;
  const int blocks = (nblk + TGX_WARPS - 1) / TGX_WARPS;
  seg_weights_kernel<<<blocks, 32 * TGX_WARPS, 0, (cudaStream_t)stream>>>(
      r0, r1, d2, cf, t, nblk, n_hit);
  return (int)cudaGetLastError();
}
