// Design probe for tokengeex_tpu_torch's forward scan (not built by the
// package): the forward log-sum-exp DP over a start-indexed (W, L, B)
// score cache with a chain's L lengths on 16 lanes and the sum taken by a
// butterfly of shuffles, to set against csrc/forward_chunk.cu, whose sum
// runs in ascending order as its twin's does. Run by
// experiments/torch_scan_design.py on the card.
//
// One 16-lane group per chain (row r, segment k; L <= 16), two chains per
// warp, each walking its own chain [seg[k], seg[k+1]). Per step lane j
// loads the token of length j+1 ending at q+1 (cache[q - j, j, r]); the
// max and the sum go by __shfl_xor_sync inside the group, every lane
// takes one expf, and the history shifts by __shfl_up_sync. Loads run D
// steps ahead in a register double buffer. No dropout.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o <lib> experiments/torch_scan_lanes.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TGX_NEG (-3.0e38f)

template <int D>
__global__ void lane_forward_kernel(const float* __restrict__ score,
                                    const float* __restrict__ reset,
                                    const float* __restrict__ hist_in,
                                    const int32_t* __restrict__ seg,
                                    float* __restrict__ a, int L, int B,
                                    int K) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int chain = gid >> 4;
  const int j = gid & 15;
  const unsigned gmask = 0xffffu << (threadIdx.x & 16);
  if (chain >= K * B) return;  // whole groups leave together
  const int k = chain / B;
  const int r = chain % B;
  const size_t Bs = (size_t)B;
  const int b0 = seg[k * Bs + r];
  const int b1 = seg[(k + 1) * Bs + r];
  const long long qs = (long long)L * B;
  const long long js = (long long)B - qs;

  float h = TGX_NEG;
  if (j < L) h = (b0 == 0) ? hist_in[j * Bs + r] : (j == 0 ? 0.0f : TGX_NEG);

  float buf[D], rs[D], nxt[D], nrs[D];
  auto load = [&](float* s, float* f, int q0) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int q = q0 + i;
      const bool in = q < b1;
      s[i] = (in && j < L && q - j >= 0)
                 ? score[(long long)q * qs + j * js + r] : TGX_NEG;
      f[i] = in ? reset[(size_t)q * Bs + r] : 0.0f;
    }
  };
  load(buf, rs, b0);
  for (int q0 = b0; q0 < b1; q0 += D) {
    load(nxt, nrs, q0 + D);  // in flight while this block of D computes
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int q = q0 + i;
      if (q >= b1) break;  // uniform in the group
      const float cand = (j < L) ? h + fmaxf(buf[i], TGX_NEG) : -INFINITY;
      float m = cand;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(gmask, m, o));
      const bool has = m > TGX_NEG * 0.5f;
      const float safe = has ? m : 0.0f;
      float t = (j < L) ? expf(cand - safe) : 0.0f;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) t += __shfl_xor_sync(gmask, t, o);
      const float v = has ? safe + logf(t) : TGX_NEG;
      if (j == 0) a[(size_t)q * Bs + r] = v;
      const float carry = (rs[i] > 0.5f) ? 0.0f : v;
      const float up = __shfl_up_sync(gmask, h, 1, 16);
      h = (j == 0) ? carry : up;
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      buf[i] = nxt[i];
      rs[i] = nrs[i];
    }
  }
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tgx_lane_forward(const float* score, const float* reset,
                                const float* hist_in, const int32_t* seg,
                                float* a, int L, int B, int K, void* stream) {
  if (L > 16) return (int)cudaErrorInvalidValue;
  const int threads = 128;  // 8 chains per block
  const long long lanes = 16LL * K * B;
  const int blocks = (int)((lanes + threads - 1) / threads);
  lane_forward_kernel<8><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      score, reset, hist_in, seg, a, L, B, K);
  return (int)cudaGetLastError();
}
