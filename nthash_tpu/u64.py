"""uint64 arithmetic as (hi32, lo32) uint32 limb pairs.

JAX runs with 64-bit integers disabled by default, so every hash value in
the device engines is a pair of uint32 arrays. This module implements
exactly the operations ntHash needs — xor, add (mod 2^64), the 33|31
split-rotates, right shifts, and multiply-by-constant — as branch-free
elementwise uint32 ops, valid both in XLA code and inside the Triton kernel.

Split-rotate semantics match reference src/internal.hpp:41-66, 83-88:
bits 0..32 (the 33-bit sub-word) and bits 33..63 (the 31-bit sub-word)
rotate independently.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .constants import M64

_U32 = jnp.uint32


class U64(NamedTuple):
    """A uint64 value (or array) as two uint32 limbs. NamedTuple => pytree."""

    hi: jnp.ndarray
    lo: jnp.ndarray

    @staticmethod
    def const(value: int, shape=(), dtype=_U32) -> "U64":
        """Trace-time constant broadcastable to ``shape``."""
        value &= M64
        hi = jnp.full(shape, (value >> 32) & 0xFFFFFFFF, dtype=dtype)
        lo = jnp.full(shape, value & 0xFFFFFFFF, dtype=dtype)
        return U64(hi, lo)

    @staticmethod
    def zeros(shape=(), dtype=_U32) -> "U64":
        return U64(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))

    @staticmethod
    def from_np(arr) -> "U64":
        """Host uint64 ndarray -> device limb pair."""
        arr = np.asarray(arr, dtype=np.uint64)
        hi = jnp.asarray((arr >> np.uint64(32)).astype(np.uint32))
        lo = jnp.asarray((arr & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        return U64(hi, lo)

    def to_np(self) -> np.ndarray:
        """Device limb pair -> host uint64 ndarray."""
        hi = np.asarray(self.hi, dtype=np.uint64)
        lo = np.asarray(self.lo, dtype=np.uint64)
        return (hi << np.uint64(32)) | lo


def xor(a: U64, b: U64) -> U64:
    return U64(a.hi ^ b.hi, a.lo ^ b.lo)


def add(a: U64, b: U64) -> U64:
    """(a + b) mod 2^64 with carry between limbs."""
    lo = a.lo + b.lo
    carry = (lo < a.lo).astype(_U32)
    return U64(a.hi + b.hi + carry, lo)


def srol1(a: U64) -> U64:
    """Split-rotate-left by 1: bit32 -> bit0, bit63 -> bit33."""
    hi_shift = (a.hi << 1) | (a.lo >> 31)
    hi = (hi_shift & jnp.uint32(0xFFFFFFFD)) | ((a.hi >> 31) << 1)
    lo = ((a.lo << 1) & jnp.uint32(0xFFFFFFFE)) | (a.hi & 1)
    return U64(hi, lo)


def sror1(a: U64) -> U64:
    """Split-rotate-right by 1: bit0 -> bit32, bit33 -> bit63."""
    lo = (a.lo >> 1) | (a.hi << 31)
    hi = ((a.hi >> 1) & jnp.uint32(0x7FFFFFFE)) | ((a.hi & 2) << 30) | (a.lo & 1)
    return U64(hi, lo)


def shr(a: U64, s: int) -> U64:
    """Logical right shift by a static amount 0 <= s < 64."""
    if s == 0:
        return a
    if s < 32:
        return U64(a.hi >> s, (a.lo >> s) | (a.hi << (32 - s)))
    if s == 32:
        return U64(jnp.zeros_like(a.hi), a.hi)
    return U64(jnp.zeros_like(a.hi), a.hi >> (s - 32))


def shl(a: U64, s: int) -> U64:
    """Left shift (mod 2^64) by a static amount 0 <= s < 64."""
    if s == 0:
        return a
    if s < 32:
        return U64((a.hi << s) | (a.lo >> (32 - s)), a.lo << s)
    if s == 32:
        return U64(a.lo, jnp.zeros_like(a.lo))
    return U64(a.lo << (s - 32), jnp.zeros_like(a.lo))


def _mulhi32(x: jnp.ndarray, y_const: int) -> jnp.ndarray:
    """High 32 bits of x * y_const for uint32 x and a 32-bit constant.

    16-bit limb decomposition: exact in uint32 arithmetic on every backend.
    """
    yl = jnp.uint32(y_const & 0xFFFF)
    yh = jnp.uint32((y_const >> 16) & 0xFFFF)
    xl = x & jnp.uint32(0xFFFF)
    xh = x >> 16
    p0 = xl * yl
    p1 = xh * yl
    p2 = xl * yh
    p3 = xh * yh
    t = (p0 >> 16) + (p1 & jnp.uint32(0xFFFF)) + (p2 & jnp.uint32(0xFFFF))
    return p3 + (p1 >> 16) + (p2 >> 16) + (t >> 16)


def mul_const(a: U64, m: int) -> U64:
    """(a * m) mod 2^64 for a trace-time constant m."""
    m &= M64
    mlo = m & 0xFFFFFFFF
    mhi = (m >> 32) & 0xFFFFFFFF
    lo = a.lo * jnp.uint32(mlo)
    hi = _mulhi32(a.lo, mlo)
    if mhi:
        hi = hi + a.lo * jnp.uint32(mhi)
    if mlo:
        hi = hi + a.hi * jnp.uint32(mlo)
    return U64(hi, lo)


def select(pred: jnp.ndarray, a: U64, b: U64) -> U64:
    """Elementwise pred ? a : b."""
    return U64(jnp.where(pred, a.hi, b.hi), jnp.where(pred, a.lo, b.lo))


def take(table: U64, idx: jnp.ndarray) -> U64:
    """Gather rows of a small table by index."""
    return U64(jnp.take(table.hi, idx, axis=0), jnp.take(table.lo, idx, axis=0))


def lookup5(idx: jnp.ndarray, values: tuple[int, ...]) -> U64:
    """Branch-free 5-way constant lookup: values[idx] with values[4] == 0.

    The workhorse select for seed planes: codes 0..3 pick a per-base constant,
    code 4 (N/invalid) picks zero. Lowered as a where-chain of selects (no
    gather), which fuses into the surrounding elementwise work.
    """
    assert len(values) == 5 and (values[4] & M64) == 0
    hi = jnp.zeros(idx.shape, _U32)
    lo = jnp.zeros(idx.shape, _U32)
    for code in range(4):
        v = values[code] & M64
        match = idx == code
        hi = jnp.where(match, jnp.uint32((v >> 32) & 0xFFFFFFFF), hi)
        lo = jnp.where(match, jnp.uint32(v & 0xFFFFFFFF), lo)
    return U64(hi, lo)


def extend_hashes(canon: U64, k: int, num_hashes: int) -> list[U64]:
    """nte64 multi-hash extension on device (reference src/internal.hpp:104-118).

    hash_0 = canonical; hash_i = h0 * (i ^ k*MULTISEED); h_i ^= h_i >> 27.
    The multiplier is a trace-time constant per (i, k).
    """
    from .constants import MULTISHIFT, nte64_multiplier

    out = [canon]
    for i in range(1, num_hashes):
        t = mul_const(canon, nte64_multiplier(i, k))
        t = xor(t, shr(t, MULTISHIFT))
        out.append(t)
    return out
