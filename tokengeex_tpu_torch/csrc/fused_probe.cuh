// Shared by the fused kernels (fused_forward.cu, fused_backward.cu) and
// the slab route's probe (match_probe.cu): the vocabulary probe of one
// (fingerprint, length) point against the two cuckoo tables.
//
// A table row is [check, f32 score bits], check = fp2 ^ rotl(fp1, 16)
// (ops/hashing.py `host_check`: T2's slot fixes the high bits of fp2, so
// fp2 alone would be a weak check there). The slot of a token of
// length l is ((fp ^ l*A) * M) >>> (32 - bits) per family (ops/hashing.py);
// T1 wins over T2, and a T1 slot holding the empty-slot score sentinel
// never counts (a zero-check pseudo-hit on an empty slot must not override
// a true T2 match).

#pragma once

#include "scan_lanes.cuh"

// f32 -3.0e38 as int32 bits: the empty-slot score sentinel.
#define TGX_NEG_BITS ((int32_t)0xFF61B1E6)

#define TGX_IDX_A1 0x27D4EB2Fu
#define TGX_IDX_M1 0x165667B1u
#define TGX_IDX_A2 0x9E3779B9u
#define TGX_IDX_M2 0xC2B2AE35u

// Steps the lane-parallel scans' probe runs ahead of the recurrence: the
// stream words of step t are loaded at step t - 2D, its table rows
// gathered at step t - D (two register rings of D slots).
#define TGX_FUSED_D 4

__device__ __forceinline__ uint32_t tgx_slot1(uint32_t fp1, uint32_t l,
                                              int shift) {
  return ((fp1 ^ (l * TGX_IDX_A1)) * TGX_IDX_M1) >> shift;
}

__device__ __forceinline__ uint32_t tgx_slot2(uint32_t fp2, uint32_t l,
                                              int shift) {
  return ((fp2 ^ (l * TGX_IDX_A2)) * TGX_IDX_M2) >> shift;
}

__device__ __forceinline__ uint32_t tgx_check(uint32_t fp1, uint32_t fp2) {
  return fp2 ^ ((fp1 << 16) | (fp1 >> 16));
}

// The score of a probed point from its two gathered rows: a T1 hit, else
// a T2 hit, counted only when `ok` (the token fits its sample run and its
// dropout coin is not drawn) and above NEG / 2; NEG otherwise.
__device__ __forceinline__ float tgx_probe_score(int2 r1, int2 r2,
                                                 uint32_t check, bool ok) {
  int32_t sb = TGX_NEG_BITS;
  if ((uint32_t)r2.x == check) sb = r2.y;
  if ((uint32_t)r1.x == check && r1.y != TGX_NEG_BITS) sb = r1.y;
  const float sf = __int_as_float(sb);
  return (ok && sf > TGX_NEG * 0.5f) ? sf : TGX_NEG;
}
