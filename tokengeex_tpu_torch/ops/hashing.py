"""Shared 32-bit polynomial hashing for token matching.

The TPU-native replacement for the reference's byte trie
(reference: src/trie.rs) is a dense lookup: every (position, length)
substring of a byte window is fingerprinted with two independent
32-bit polynomial hashes and probed against a cuckoo hash table of the
vocabulary. These helpers define the hash family and must produce
IDENTICAL bit patterns on host (numpy uint32) and device (jnp int32,
two's-complement wraparound).

fingerprint(bytes b[0..l)) = sum_k b[k] * R^k  (mod 2^32)

On device, per-lane prefix hashes P[p] = sum_{k<p} b[k]*R^k allow any
substring fingerprint in O(1):
    fp(p, l) = (P[p+l] - P[p]) * R^-p   (mod 2^32)
R is odd so R^-1 exists mod 2^32.
"""

from __future__ import annotations

import numpy as np
import torch

# Two independent odd multipliers (random odd 32-bit constants).
R1 = np.uint32(0x9E3779B1)  # golden-ratio prime, odd
R2 = np.uint32(0x85EBCA77)

# Mixers for table index derivation.
IDX_A1 = np.uint32(0x27D4EB2F)
IDX_M1 = np.uint32(0x165667B1)
IDX_A2 = np.uint32(0x9E3779B9)
IDX_M2 = np.uint32(0xC2B2AE35)


def modinv_pow2_32(r: int) -> int:
    """Inverse of odd r modulo 2^32 via Newton iteration."""
    assert r % 2 == 1
    x = r
    for _ in range(5):
        x = (x * (2 - r * x)) % (1 << 32)
    assert (x * r) % (1 << 32) == 1
    return x


R1_INV = np.uint32(modinv_pow2_32(int(R1)))
R2_INV = np.uint32(modinv_pow2_32(int(R2)))


def host_fingerprints(data: bytes) -> tuple:
    """(fp1, fp2) of a byte string, matching the device formula."""
    fp1 = np.uint32(0)
    fp2 = np.uint32(0)
    p1 = np.uint32(1)
    p2 = np.uint32(1)
    with np.errstate(over="ignore"):
        for b in data:
            fp1 = np.uint32(fp1 + np.uint32(b) * p1)
            fp2 = np.uint32(fp2 + np.uint32(b) * p2)
            p1 = np.uint32(p1 * R1)
            p2 = np.uint32(p2 * R2)
    return fp1, fp2


def host_table_index(fp: np.ndarray, length: np.ndarray, a: np.uint32,
                     m: np.uint32, bits: int) -> np.ndarray:
    """Slot index from fingerprint+length (host side, uint32 arrays)."""
    with np.errstate(over="ignore"):
        u = (fp ^ (length.astype(np.uint32) * a)) * m
    return (u >> np.uint32(32 - bits)).astype(np.int64)


def host_bucket_index(fp: np.ndarray, length: np.ndarray, salt: int,
                      bits: int) -> np.ndarray:
    """Bucket index for the single-probe table: like host_table_index
    but with a retryable salt folded into the mix."""
    with np.errstate(over="ignore"):
        u = ((fp ^ (length.astype(np.uint32) * IDX_A1) ^ np.uint32(salt))
             * IDX_M1)
    return (u >> np.uint32(32 - bits)).astype(np.int64)


def powers_u32(r: np.uint32, n: int) -> np.ndarray:
    """[r^0, r^1, ..., r^(n-1)] as uint32."""
    out = np.empty(n, dtype=np.uint32)
    x = np.uint32(1)
    with np.errstate(over="ignore"):
        for i in range(n):
            out[i] = x
            x = np.uint32(x * r)
    return out


# ---------------------------------------------------------------------------
# Torch helpers: int32 two's-complement arithmetic.
#
# Torch's int32 `*` relies on C++ signed overflow and its `>>` on int32 is
# arithmetic, so the hash family is computed in int64 and wrapped back:
# the product of two int32 values fits in int64, and the low 32 bits are
# the two's-complement result the device formula needs.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def i32(u: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    u %= 1 << 32
    return u - (1 << 32) if u >= (1 << 31) else u


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 tensor as int32."""
    x = x & _M32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def mul_i32(a: torch.Tensor, b) -> torch.Tensor:
    """a * b mod 2^32 for int32 tensors (or an int32 constant b)."""
    b = b.to(torch.int64) if isinstance(b, torch.Tensor) else int(b)
    return wrap_i32(a.to(torch.int64) * b)


def sub_i32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return wrap_i32(a.to(torch.int64) - b.to(torch.int64))


def srl_i32(a: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of an int32 tensor by k >= 1 bits."""
    return ((a.to(torch.int64) & _M32) >> k).to(torch.int32)


def host_check(fp1: np.ndarray, fp2: np.ndarray) -> np.ndarray:
    """The check word of a cuckoo row and of a probe: fp2 ^ rotl(fp1, 16)
    (uint32). T2's slot is a function of fp2 alone, so a check of fp2
    alone would let any substring whose fp2 shares its slot's high bits
    (2^-(32 - bits) per probe of an occupied slot) pass as the occupant;
    the check mixes in fp1, which the slot does not fix."""
    fp1 = np.asarray(fp1).astype(np.uint32)
    fp2 = np.asarray(fp2).astype(np.uint32)
    return fp2 ^ ((fp1 << np.uint32(16)) | (fp1 >> np.uint32(16)))


def check_i32(fp1: torch.Tensor, fp2: torch.Tensor) -> torch.Tensor:
    """`host_check` on int32 tensors."""
    a = fp1.to(torch.int64) & _M32
    return wrap_i32((fp2.to(torch.int64) & _M32)
                    ^ (((a << 16) | (a >> 16)) & _M32))


def cumsum_i32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sum mod 2^32 (int32 in, int32 out)."""
    return wrap_i32(torch.cumsum(x.to(torch.int64), dim=dim))
