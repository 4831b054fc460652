"""uint64 arithmetic as uint32 limb pairs.

64-bit integers in jax require jax_enable_x64, which is process-global, and
the design once targeted an accelerator without 64-bit integer units. The
GPU has them; whether native u64 pays is ROADMAP Design 4, decided by
measurement. The limb form is exact on every backend. We represent a
uint64 value x as a pair of uint32 arrays ``(hi, lo)`` with
``x = hi * 2**32 + lo`` and implement exactly the operations the k-mer /
XXH64 pipeline needs: add, xor/or/and, static shifts, rotations, low-64
multiplication, comparison, and min.

All functions are shape-polymorphic elementwise ops over arbitrary jnp
arrays and are safe inside jit / shard_map / pallas bodies.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

U64 = Tuple[jnp.ndarray, jnp.ndarray]  # (hi, lo), both uint32

_U32 = jnp.uint32


def from_py(value: int, like: jnp.ndarray | None = None) -> U64:
    """Constant u64 from a Python int (broadcast against `like` if given)."""
    value &= (1 << 64) - 1
    hi = jnp.asarray((value >> 32) & 0xFFFFFFFF, dtype=_U32)
    lo = jnp.asarray(value & 0xFFFFFFFF, dtype=_U32)
    if like is not None:
        hi = jnp.broadcast_to(hi, like.shape)
        lo = jnp.broadcast_to(lo, like.shape)
    return hi, lo


def from_u32(lo: jnp.ndarray) -> U64:
    lo = lo.astype(_U32)
    return jnp.zeros_like(lo), lo


def add(a: U64, b: U64) -> U64:
    lo = a[1] + b[1]
    carry = (lo < a[1]).astype(_U32)
    hi = a[0] + b[0] + carry
    return hi, lo


def xor(a: U64, b: U64) -> U64:
    return a[0] ^ b[0], a[1] ^ b[1]


def or_(a: U64, b: U64) -> U64:
    return a[0] | b[0], a[1] | b[1]


def and_(a: U64, b: U64) -> U64:
    return a[0] & b[0], a[1] & b[1]


def shli(a: U64, s: int) -> U64:
    """Static left shift by s in [0, 64)."""
    hi, lo = a
    if s == 0:
        return a
    if s < 32:
        return (hi << s) | (lo >> (32 - s)), lo << s
    if s == 32:
        return lo, jnp.zeros_like(lo)
    return lo << (s - 32), jnp.zeros_like(lo)


def shri(a: U64, s: int) -> U64:
    """Static logical right shift by s in [0, 64)."""
    hi, lo = a
    if s == 0:
        return a
    if s < 32:
        return hi >> s, (lo >> s) | (hi << (32 - s))
    if s == 32:
        return jnp.zeros_like(hi), hi
    return jnp.zeros_like(hi), hi >> (s - 32)


def rotli(a: U64, s: int) -> U64:
    """Static rotate-left by s in (0, 64)."""
    return or_(shli(a, s), shri(a, 64 - s))


def _mul32_hilo(x: jnp.ndarray, y: jnp.ndarray) -> U64:
    """Full 32x32 -> 64 product via 16-bit half-limbs (all ops uint32)."""
    x0 = x & 0xFFFF
    x1 = x >> 16
    y0 = y & 0xFFFF
    y1 = y >> 16
    ll = x0 * y0
    lh = x0 * y1
    hl = x1 * y0
    hh = x1 * y1
    mid = lh + hl  # may wrap: carry is worth 2**32 at bit 16 => 2**16 in hi
    mid_carry = (mid < lh).astype(_U32)
    lo = ll + (mid << 16)
    lo_carry = (lo < ll).astype(_U32)
    hi = hh + (mid >> 16) + (mid_carry << 16) + lo_carry
    return hi, lo


def mul(a: U64, b: U64) -> U64:
    """Low 64 bits of a*b (wrapping), matching C uint64_t multiplication."""
    hi, lo = _mul32_hilo(a[1], b[1])
    cross = a[1] * b[0] + a[0] * b[1]  # wrapping uint32: only low 32 survive
    return hi + cross, lo


def mul_const(a: U64, c: int) -> U64:
    return mul(a, from_py(c))


def lt(a: U64, b: U64) -> jnp.ndarray:
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def eq(a: U64, b: U64) -> jnp.ndarray:
    return (a[0] == b[0]) & (a[1] == b[1])


def min_(a: U64, b: U64) -> U64:
    a_lt = lt(a, b)
    return jnp.where(a_lt, a[0], b[0]), jnp.where(a_lt, a[1], b[1])


def select(pred: jnp.ndarray, a: U64, b: U64) -> U64:
    return jnp.where(pred, a[0], b[0]), jnp.where(pred, a[1], b[1])


def to_py(a: U64) -> int:
    """Host-side: collapse a scalar u64 to a Python int (for tests)."""
    return (int(a[0]) << 32) | int(a[1])
