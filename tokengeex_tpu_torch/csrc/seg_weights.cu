// Segsum: a row group's expected counts over the sorted-hit order, for
// Hopper (sm_90a).
//
// Replaces: tokengeex_tpu/ops/lattice_pallas_fused.py `seg_weights`
// (`_seg_weights_kernel`, `_lane_cumsum`), and the XLA program around it,
// tokengeex_tpu/ops/lattice_jax.py `_segsum_expected_impl` (the alpha - Z
// plane, the telescoping score differences and block anchors, the interval
// sums of `_interval_from_blocks` and the accumulate).
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
// plain version, which takes the same steps, rounds alike. Each occurring
// slot's count is then the sum of w over its segment of the sorted hits.
//
// Three entry points:
//   - `seg_weights` (one length's streams r0, r1, d2 as (H,) arrays): the
//     Pallas kernel's counterpart, not on the main path.
//   - `seg_weights_gather` (a row group's every token length in one
//     cooperative launch, laid end to end: length l0 holds the blocks
//     [boff[l0], boff[l0+1]), a capacity that is a multiple of 128, so no
//     block straddles two lengths). A prologue over the grid writes the
//     (B, W) plane col1 = alpha - Z (alpha 0 at a sample start, Z the
//     sample's total, 0 where not finite or below -1e37), and zeroes the
//     accumulator and the full-block sums; after a grid barrier a warp a
//     block gathers its hits' streams at the flat position pos = b * W + w:
//       r0 = col1[pos]
//       r1 = w + l0 + 1 <= W ? bt[b, w + l0 + 1] : -inf, and -inf where the
//            token's dropout coin from du[b, pad + w] drops it (l0 > 0)
//       d2 = k == 0 ? sc(blk_slot[block])
//                   : sc(occ[o]) - sc(occ[o - 1]) where segment o starts
//                     at k (0 elsewhere)
//     with sc(s) = max(score(s), -200) and sc(nbins) = 0; the segments
//     starting in the block follow the one holding its first hit
//     (`blk_occ`, made once with the SegStruct). These are the streams the
//     torch code built, bit for bit. A block wholly inside one segment adds
//     its total, in fixed point (truncated to 2^-mid_bits), to that
//     segment's int64 sum `mid`: integer adds give the same bits in any
//     order, so the count is deterministic without a scan across blocks.
//   - `seg_sums` (a thread an occurring (length, slot) entry): the
//     segment's sum is its head (the first block's total minus cf before
//     the segment), `mid` and its tail (cf at its end), or within one block
//     cf[end] - cf[start - 1], added in double, raised to 0 where the
//     scans' rounding takes it below (the Hillis-Steele scan is not
//     monotone: cf can fall by an ulp over a run of zero weights), and
//     rounded once to float.
//     One token has one length, so a slot occurs at one length, except
//     where a hash false positive puts it at a second: the entry of its
//     shortest length sums the lengths' values in ascending length (the
//     `nxt` chain, made with the SegStruct) as float adds, the order of the
//     JAX package's accumulate, and stores the slot's count. No float
//     atomics: two calls give the same bits.
//
// What bounds it on the H100. The weights: bytes. The hit's position and
// its output, 8 bytes per hit, the (B, W) planes read once (the prologue:
// alpha, the sample ends and starts in, alpha - Z out); the planes' gathers
// follow the sorted order, so they are scattered, but a row group's planes
// (16 MB each) stay in the 50 MB L2. The sums: a launch, for ~12 bytes per
// occurring entry.
//
// What the design does about it: one warp per 128-hit block, 4 hits per
// lane at k = lane + 32 c, so every load and store of a column c is one
// coalesced 128-byte transaction. A scan step's neighbour `stride` places
// back is a warp shuffle (stride < 32, from column c or c - 1) or another
// register of the same lane (stride 32 or 64). A block's score differences
// come from the few segments starting in it (a warp's row of shared
// memory), so no (H,) array of differences is written or read. The
// gather kernel runs persistent blocks, as many as fit on the card
// (cooperative launch), so that its prologue and the gathers are one
// launch; the sums are the second.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tokengeex_tpu_torch/ops/_build.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "scan_lanes.cuh"

namespace cg = cooperative_groups;

#define TGX_SEG_BLK 128
#define TGX_WARPS 8        // warps (128-hit blocks) per thread block
#define TGX_MID_LIMIT 256.0f  // a full block's total above this poisons
#define TGX_POISON 0x8000000000000000ull

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

// ---------------------------------------------------------------------------
// Streams of one length
// ---------------------------------------------------------------------------

__global__ void seg_weights_kernel(const float* __restrict__ r0,
                                   const float* __restrict__ r1,
                                   const float* __restrict__ d2,
                                   float* __restrict__ cf,
                                   float* __restrict__ t, int nblk,
                                   int n_hit) {
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

// Streams of one length; H must be a multiple of 128. Returns
// cudaGetLastError() after the launch (0 on success).
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

// ---------------------------------------------------------------------------
// A row group's every length, its streams gathered in the kernel
// ---------------------------------------------------------------------------

struct GatherArgs {
  const int32_t* perm;       // (H,) flat hit positions b * W + w
  const int32_t* blk_slot;   // (H / 128,) slot at each block's first hit
  const int32_t* blk_occ;    // (H / 128,) entry o holding it, OC past them
  const int32_t* occ;        // (L, OC) occurring slots, pad nbins
  const int32_t* pre;        // (L, OC) index before each segment, or cap
  const int32_t* end;        // (L, OC) its last index, cap for a pad
  const int32_t* meta;       // (2L + 1,): boff[0..L] in blocks, n_hit[L]
  const float* A;            // (B, W + 1) forward values
  const int32_t* end_index;  // (B, W) each position's sample end
  const uint8_t* is_start;   // (B, W + 1) bool
  const float* bt;           // (B, W + 1) betas
  const int32_t* score;      // (nbins + 1,) f32 score bits per slot
  const int32_t* du;         // (B, du_stride), DROP only
  int L, OC, W, B, nbins, du_stride, pad, nblk;
  uint32_t thr_half;
  double scale;  // 2^mid_bits
  // out
  float* col1;     // (B, W) alpha - Z, scratch
  float* cf;       // (H,)
  float* t;        // (H / 128,)
  long long* mid;  // (L * OC,) fixed-point full-block sums
  float* acc;      // (nbins + 1,) zeroed
};

// The clamped score of a slot, 0 for the pad slot nbins (torch.clamp's min:
// NaN stays NaN); a slot out of range reads 0, never outside the column.
__device__ __forceinline__ float seg_score(const GatherArgs& p, int s) {
  if ((unsigned)s >= (unsigned)p.nbins) return 0.0f;
  const float v = __int_as_float(p.score[s]);
  return (v < -200.0f) ? -200.0f : v;
}

template <bool DROP>
__global__ void __launch_bounds__(32 * TGX_WARPS)
    seg_gather_kernel(const GatherArgs p) {
  __shared__ float dsm[TGX_WARPS][TGX_SEG_BLK];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nthreads = (size_t)gridDim.x * blockDim.x;

  // Prologue: alpha - Z per position, the accumulator and the sums zeroed.
  const size_t BW = (size_t)p.B * p.W;
  for (size_t i = tid; i < BW; i += nthreads) {
    const size_t b = i / (size_t)p.W;
    const size_t w = i - b * p.W;
    const size_t row = b * (p.W + 1);
    const int e = min(max(p.end_index[i], 0), p.W);
    const float z = p.A[row + e];
    const float zc = (isfinite(z) && z > -1e37f) ? z : 0.0f;
    const float a = p.is_start[row + w] ? 0.0f : p.A[row + w];
    p.col1[i] = a - zc;
  }
  for (size_t i = tid; i < (size_t)p.L * p.OC; i += nthreads) p.mid[i] = 0;
  for (size_t i = tid; i <= (size_t)p.nbins; i += nthreads) p.acc[i] = 0.0f;
  cg::this_grid().sync();

  const int warp = (int)(tid >> 5);
  const int nwarps = (int)(nthreads >> 5);
  for (int blk = warp; blk < p.nblk; blk += nwarps) {
    const size_t base = (size_t)blk * TGX_SEG_BLK;
    // The block's length: l0 counts the lengths that begin at or before it.
    int l0 = 0;
    for (int l = 1; l < p.L; ++l) l0 += (blk >= p.meta[l]) ? 1 : 0;
    const int fb = p.meta[l0];
    const int cap = (p.meta[l0 + 1] - fb) * TGX_SEG_BLK;
    const int n_hit = p.meta[p.L + 1 + l0];
    const int lstart = (blk - fb) * TGX_SEG_BLK;  // within the length
    const int32_t* occ = p.occ + (size_t)l0 * p.OC;
    const int32_t* pre = p.pre + (size_t)l0 * p.OC;
    const int32_t* end = p.end + (size_t)l0 * p.OC;
    const int o0 = p.blk_occ[blk];

    // The score differences at the segments starting inside the block,
    // through this warp's row of shared memory.
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 4; ++c) dsm[wib][lane + 32 * c] = 0.0f;
    __syncwarp();
    for (int o1 = o0 + 1;; o1 += 32) {
      const int o = o1 + lane;
      bool in = false;
      if (o < p.OC) {
        const int en = end[o];
        if (en != cap) {
          const int pr = pre[o];
          const int st = (pr == cap) ? 0 : pr + 1;
          in = st > lstart && st < lstart + TGX_SEG_BLK;
          if (in)
            dsm[wib][st - lstart] =
                0.0f + (seg_score(p, occ[o]) - seg_score(p, occ[o - 1]));
        }
      }
      // Starts ascend with o: a lane past the block ends the walk.
      if (!__all_sync(TGX_FULL, in)) break;
    }
    __syncwarp();
    float x[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] = dsm[wib][lane + 32 * c];
    if (lane == 0) x[0] = seg_score(p, p.blk_slot[blk]);
    lane_cumsum(x, lane);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = lane + 32 * c;
      const size_t i = base + k;
      // Clamped, so that a bad position reads a wrong value, never outside
      // the planes.
      const uint32_t pos = (uint32_t)min(max(p.perm[i], 0), (int)BW - 1);
      const uint32_t b = pos / (uint32_t)p.W;
      const uint32_t w = pos - b * (uint32_t)p.W;
      const float r0 = p.col1[pos];
      const uint32_t wi = w + (uint32_t)l0 + 1u;
      float r1 = (wi <= (uint32_t)p.W) ? p.bt[(size_t)b * (p.W + 1) + wi]
                                       : -INFINITY;
      if constexpr (DROP) {
        const uint32_t u = (uint32_t)p.du[(size_t)b * p.du_stride + p.pad + w];
        r1 = tgx_dropped(u, l0, p.thr_half) ? -INFINITY : r1;
      }
      const float wt = expf((r0 + r1) + x[c]);
      x[c] = (lstart + k < n_hit) ? wt : 0.0f;
    }
    lane_cumsum(x, lane);
#pragma unroll
    for (int c = 0; c < 4; ++c) p.cf[base + lane + 32 * c] = x[c];
    if (lane == 31) {
      p.t[blk] = x[3];
      // A block wholly inside one real segment: its total goes to the
      // segment's fixed-point sum.
      if (o0 < p.OC) {
        const int en = end[o0];
        if (en != cap && en >= lstart + TGX_SEG_BLK - 1) {
          unsigned long long* m =
              (unsigned long long*)(p.mid + (size_t)l0 * p.OC + o0);
          const float tot = x[3];
          if (tot <= TGX_MID_LIMIT)
            atomicAdd(m, (unsigned long long)__double2ll_rz(
                             __dmul_rn((double)tot, p.scale)));
          else
            atomicOr(m, TGX_POISON);
        }
      }
    }
  }
}

// The grid of the cooperative launch: as many blocks as fit on the card.
template <bool DROP>
static int gather_grid(int* grid) {
  static int cached[64][2];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  int& g = cached[dev & 63][DROP ? 1 : 0];
  if (g == 0) {
    int sms = 0, per = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return (int)rc;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, seg_gather_kernel<DROP>, 32 * TGX_WARPS, 0);
    if (rc != cudaSuccess) return (int)rc;
    if (per < 1) return (int)cudaErrorInvalidConfiguration;
    g = sms * per;
  }
  *grid = g;
  return 0;
}

template <bool DROP>
static int launch_gather(GatherArgs& args, cudaStream_t stream) {
  int grid = 0;
  const int rc = gather_grid<DROP>(&grid);
  if (rc != 0) return rc;
  void* params[] = {&args};
  cudaLaunchCooperativeKernel((const void*)seg_gather_kernel<DROP>,
                              dim3(grid), dim3(32 * TGX_WARPS), params, 0,
                              stream);
  return (int)cudaGetLastError();
}

// Every length of a row group in one cooperative launch: H hits in L
// lengths as `meta` lays them out (H a multiple of 128, B * W < 2^31). du
// may be null when use_drop == 0. Writes col1, cf, t, mid (full-block sums
// at 2^-mid_bits) and zeroes acc. Returns cudaGetLastError() after the
// launch.
extern "C" int tgx_seg_weights_gather(
    const int32_t* perm, const int32_t* blk_slot, const int32_t* blk_occ,
    const int32_t* occ, const int32_t* pre, const int32_t* end,
    const int32_t* meta, const float* A, const int32_t* end_index,
    const uint8_t* is_start, const float* bt, const int32_t* score,
    const int32_t* du, float* col1, float* cf, float* t, long long* mid,
    float* acc, int H, int L, int OC, int W, int B, int nbins,
    int du_stride, int pad, int mid_bits, unsigned thr_half, int use_drop,
    void* stream) {
  if (H % TGX_SEG_BLK != 0 || L < 1 || OC < 1 || W < 1 || B < 1 ||
      nbins < 0 || mid_bits < 0 || mid_bits > 62 ||
      (long long)B * W >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  GatherArgs args = {};
  args.perm = perm;
  args.blk_slot = blk_slot;
  args.blk_occ = blk_occ;
  args.occ = occ;
  args.pre = pre;
  args.end = end;
  args.meta = meta;
  args.A = A;
  args.end_index = end_index;
  args.is_start = is_start;
  args.bt = bt;
  args.score = score;
  args.du = du;
  args.L = L;
  args.OC = OC;
  args.W = W;
  args.B = B;
  args.nbins = nbins;
  args.du_stride = du_stride;
  args.pad = pad;
  args.nblk = H / TGX_SEG_BLK;
  args.thr_half = thr_half;
  args.scale = ldexp(1.0, mid_bits);
  args.col1 = col1;
  args.cf = cf;
  args.t = t;
  args.mid = mid;
  args.acc = acc;
  cudaStream_t s = (cudaStream_t)stream;
  return use_drop ? launch_gather<true>(args, s) : launch_gather<false>(args, s);
}

// ---------------------------------------------------------------------------
// The segments' sums into the accumulator
// ---------------------------------------------------------------------------

struct SumArgs {
  const float* cf;        // (H,)
  const float* t;         // (H / 128,)
  const long long* mid;   // (L * OC,)
  const int32_t* occ;     // (L, OC)
  const int32_t* pre;     // (L, OC)
  const int32_t* end;     // (L, OC)
  const int32_t* nxt;     // (L, OC) the entries' chain, see below
  const int32_t* meta;    // (2L + 1,)
  int L, OC;
  double inv_scale;  // 2^-mid_bits
  float* acc;        // (nbins + 1,), zeroed by seg_weights_gather
};

// The sum of w over the segment of entry i (real: its end is not the cap).
__device__ float segment_sum(const SumArgs& p, int i) {
  const int l0 = i / p.OC;
  const int fb = p.meta[l0];
  const int cap = (p.meta[l0 + 1] - fb) * TGX_SEG_BLK;
  const int pr = p.pre[i];
  const int s = (pr == cap) ? 0 : pr + 1;
  const int e = p.end[i];
  const size_t first = (size_t)fb * TGX_SEG_BLK;
  const size_t gs = first + s, ge = first + e;
  const bool open = (s & (TGX_SEG_BLK - 1)) != 0;
  const double prev = open ? (double)p.cf[gs - 1] : 0.0;
  const double ce = (double)p.cf[ge];
  double v;
  if (gs / TGX_SEG_BLK == ge / TGX_SEG_BLK) {
    v = __dsub_rn(ce, prev);
  } else {
    const double head =
        open ? __dsub_rn((double)p.t[gs / TGX_SEG_BLK], prev) : 0.0;
    const long long m = p.mid[i];
    const double md = (m >= 0) ? __dmul_rn(__ll2double_rn(m), p.inv_scale)
                               : (double)NAN;
    const double tail = ((e & (TGX_SEG_BLK - 1)) != TGX_SEG_BLK - 1) ? ce : 0.0;
    v = __dadd_rn(__dadd_rn(head, md), tail);
  }
  // A sum of marginals is never below 0; the in-block scans are not
  // monotone, so a difference of two can be, by an ulp (NaN stays NaN).
  return __double2float_rn(v < 0.0 ? 0.0 : v);
}

// nxt[i]: >= 0 the slot's first entry (its shortest length), which occurs
// again at entry nxt[i]; -1 its first and only entry; -2 a pad, or a later
// entry that is the slot's last; <= -3 a later entry, the slot occurring
// again at -3 - nxt[i].
__global__ void seg_sums_kernel(const SumArgs p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.L * p.OC) return;
  int nx = p.nxt[i];
  if (nx < -1) return;
  float tot = segment_sum(p, i);
  while (nx >= 0) {
    tot = tot + segment_sum(p, nx);
    const int n2 = p.nxt[nx];
    nx = (n2 <= -3) ? -3 - n2 : -1;
  }
  p.acc[p.occ[i]] = tot;
}

// The accumulator's occurring slots from seg_weights_gather's outputs.
// Returns cudaGetLastError() after the launch.
extern "C" int tgx_seg_sums(const float* cf, const float* t,
                            const long long* mid, const int32_t* occ,
                            const int32_t* pre, const int32_t* end,
                            const int32_t* nxt, const int32_t* meta,
                            float* acc, int L, int OC, int mid_bits,
                            void* stream) {
  if (L < 1 || OC < 1 || mid_bits < 0 || mid_bits > 62 ||
      (long long)L * OC >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  SumArgs args = {};
  args.cf = cf;
  args.t = t;
  args.mid = mid;
  args.occ = occ;
  args.pre = pre;
  args.end = end;
  args.nxt = nxt;
  args.meta = meta;
  args.L = L;
  args.OC = OC;
  args.inv_scale = ldexp(1.0, -mid_bits);
  args.acc = acc;
  const int n = L * OC;
  const int threads = 256;
  seg_sums_kernel<<<(n + threads - 1) / threads, threads, 0,
                    (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
