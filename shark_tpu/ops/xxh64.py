"""Bit-exact XXH64 of a single 8-byte little-endian key, seed 0.

This is the only hash the pipeline needs: the reference hashes each packed
canonical k-mer as XXH64(&kmer, 8, 0) (reference: kmer_utils.hpp:81-83). For
len == 8 and seed == 0 the XXH64 algorithm (reference: xxhash.hpp:427-433,
449-453, 487-489) reduces to:

    h  = PRIME5 + 8
    k1 = rotl64(x * PRIME2, 31) * PRIME1
    h ^= k1
    h  = rotl64(h, 27) * PRIME1 + PRIME4
    h ^= h >> 33;  h *= PRIME2;  h ^= h >> 29;  h *= PRIME3;  h ^= h >> 32

Two implementations: a JAX uint32-limb version for the device path (exact on
every backend without jax_enable_x64; see ops/u64.py) and a vectorized numpy
uint64 version for the host index builder / oracle. Both are verified against known-answer vectors
generated from the reference implementation.
"""

from __future__ import annotations

import numpy as np

from shark_tpu.ops import u64

PRIME1 = 11400714785074694791
PRIME2 = 14029467366897019727
PRIME3 = 1609587929392839161
PRIME4 = 9650029242287828579
PRIME5 = 2870177450012600261

_MASK64 = (1 << 64) - 1
_H_INIT = (PRIME5 + 8) & _MASK64


def xxh64_u64(x: u64.U64) -> u64.U64:
    """JAX limb-pair XXH64 of 8-byte key(s) `x`, seed 0. Elementwise."""
    k1 = u64.mul_const(x, PRIME2)
    k1 = u64.rotli(k1, 31)
    k1 = u64.mul_const(k1, PRIME1)
    h = u64.xor(u64.from_py(_H_INIT, like=x[0]), k1)
    h = u64.rotli(h, 27)
    h = u64.mul_const(h, PRIME1)
    h = u64.add(h, u64.from_py(PRIME4, like=x[0]))
    # avalanche
    h = u64.xor(h, u64.shri(h, 33))
    h = u64.mul_const(h, PRIME2)
    h = u64.xor(h, u64.shri(h, 29))
    h = u64.mul_const(h, PRIME3)
    h = u64.xor(h, u64.shri(h, 32))
    return h


def _rotl_np(x: np.ndarray, s: int) -> np.ndarray:
    s64 = np.uint64(s)
    inv = np.uint64(64 - s)
    return (x << s64) | (x >> inv)


def xxh64_np(x: np.ndarray) -> np.ndarray:
    """Host numpy XXH64 of 8-byte key(s), seed 0. x: uint64 array."""
    x = np.asarray(x, dtype=np.uint64)
    p1 = np.uint64(PRIME1)
    p2 = np.uint64(PRIME2)
    p3 = np.uint64(PRIME3)
    p4 = np.uint64(PRIME4)
    k1 = _rotl_np(x * p2, 31) * p1
    h = np.uint64(_H_INIT) ^ k1
    h = _rotl_np(h, 27) * p1 + p4
    h ^= h >> np.uint64(33)
    h *= p2
    h ^= h >> np.uint64(29)
    h *= p3
    h ^= h >> np.uint64(32)
    return h


def xxh64_int(x: int) -> int:
    """Pure-Python scalar XXH64 of one 8-byte key, seed 0 (test oracle)."""

    def rotl(v: int, s: int) -> int:
        return ((v << s) | (v >> (64 - s))) & _MASK64

    k1 = rotl((x * PRIME2) & _MASK64, 31) * PRIME1 & _MASK64
    h = _H_INIT ^ k1
    h = (rotl(h, 27) * PRIME1 + PRIME4) & _MASK64
    h ^= h >> 33
    h = (h * PRIME2) & _MASK64
    h ^= h >> 29
    h = (h * PRIME3) & _MASK64
    h ^= h >> 32
    return h
