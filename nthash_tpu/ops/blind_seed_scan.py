"""Batched stateful blind spaced-seed rolling: BlindSeedNtHash on the device.

The reference's BlindSeedNtHash (src/seed.cpp:669-737) carries per-seed
(fwd, rev) plus a k-char window and is fed one base at a time. Here that
state is a pytree of [B, S]-vectored limb pairs plus a [B, k] window, so
thousands of independent caller-fed walks advance in lockstep under
``lax.scan`` / per-step rolls.

Rolling uses the two-tap care-run updates of ops/seed_jnp.seed_taps (see
the comment above it for the derivation), with taps gathered from the
stored window at static positions instead of the input stream. roll_back
is the exact algebraic inverse, bit-for-bit (parity with reference
seed.cpp:720-737).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from .. import u64
from ..u64 import U64
from .seed_jnp import BlockTaps, seed_taps


class BlindSeedState(NamedTuple):
    """State of B independent blind spaced-seed rollers (shared seed set)."""

    fwd: U64             # [B, S]
    rev: U64             # [B, S]
    window: jnp.ndarray  # [B, k] int32 codes, window[:, 0] = oldest base
    pos: jnp.ndarray     # [B] int32


def _all_taps(seeds: Sequence[str]) -> tuple[tuple[BlockTaps, ...], ...]:
    return tuple(tuple(seed_taps(s)) for s in seeds)


@partial(jax.jit, static_argnames=("seeds",))
def init_state(windows: jnp.ndarray, seeds: tuple[str, ...]) -> BlindSeedState:
    """Initialize from [B, k] code windows (hashes immediately, like the
    BlindSeedNtHash ctor — invalid codes hash as the zero seed)."""
    from .seed_jnp import hash_kmers_seeds

    windows = windows.astype(jnp.int32)
    b, k = windows.shape
    if any(len(s) != k for s in seeds):
        raise ValueError("all seed strings must have length k")
    res = hash_kmers_seeds(windows, seeds, 1)
    fwd = U64(res.fwd.hi[:, 0], res.fwd.lo[:, 0])  # [B, S]
    rev = U64(res.rev.hi[:, 0], res.rev.lo[:, 0])
    return BlindSeedState(fwd, rev, windows, jnp.zeros(b, jnp.int32))


def _roll(all_taps, state: BlindSeedState, c_in: jnp.ndarray) -> BlindSeedState:
    k = state.window.shape[1]
    fhs, fls, rhs, rls = [], [], [], []
    for si, taps in enumerate(all_taps):
        f = u64.srol1(U64(state.fwd.hi[:, si], state.fwd.lo[:, si]))
        r = u64.sror1(U64(state.rev.hi[:, si], state.rev.lo[:, si]))
        for blk in taps:
            s, e = k - blk.off_out, k - blk.off_in
            c_enter = c_in if e == k else state.window[:, e]
            c_leave = state.window[:, s]
            f = u64.xor(f, u64.lookup5(c_enter, blk.fwd_in))
            r = u64.xor(r, u64.lookup5(c_enter, blk.rev_in))
            f = u64.xor(f, u64.lookup5(c_leave, blk.fwd_out))
            r = u64.xor(r, u64.lookup5(c_leave, blk.rev_out))
        fhs.append(f.hi), fls.append(f.lo)
        rhs.append(r.hi), rls.append(r.lo)
    window = jnp.concatenate([state.window[:, 1:], c_in[:, None]], axis=1)
    return BlindSeedState(
        U64(jnp.stack(fhs, -1), jnp.stack(fls, -1)),
        U64(jnp.stack(rhs, -1), jnp.stack(rls, -1)),
        window,
        state.pos + 1,
    )


def _roll_back(all_taps, state: BlindSeedState, c_in: jnp.ndarray) -> BlindSeedState:
    """Exact inverse of :func:`_roll`: fwd(w-1) = sror(fwd(w) ^ E ^ O),
    rev(w-1) = srol(rev(w) ^ E_r ^ O_r), taps at window positions e-1 / s-1
    (s-1 = -1 selects the incoming prepended base)."""
    k = state.window.shape[1]
    fhs, fls, rhs, rls = [], [], [], []
    for si, taps in enumerate(all_taps):
        f = U64(state.fwd.hi[:, si], state.fwd.lo[:, si])
        r = U64(state.rev.hi[:, si], state.rev.lo[:, si])
        for blk in taps:
            s, e = k - blk.off_out, k - blk.off_in
            c_enter = state.window[:, e - 1]
            c_leave = c_in if s == 0 else state.window[:, s - 1]
            f = u64.xor(f, u64.lookup5(c_enter, blk.fwd_in))
            r = u64.xor(r, u64.lookup5(c_enter, blk.rev_in))
            f = u64.xor(f, u64.lookup5(c_leave, blk.fwd_out))
            r = u64.xor(r, u64.lookup5(c_leave, blk.rev_out))
        f = u64.sror1(f)
        r = u64.srol1(r)
        fhs.append(f.hi), fls.append(f.lo)
        rhs.append(r.hi), rls.append(r.lo)
    window = jnp.concatenate([c_in[:, None], state.window[:, :-1]], axis=1)
    return BlindSeedState(
        U64(jnp.stack(fhs, -1), jnp.stack(fls, -1)),
        U64(jnp.stack(rhs, -1), jnp.stack(rls, -1)),
        window,
        state.pos - 1,
    )


@partial(jax.jit, static_argnames=("num_hashes_per_seed",))
def hashes_of(state: BlindSeedState, num_hashes_per_seed: int = 1) -> U64:
    """Current hashes, [B, S*num_hashes_per_seed] in reference hash_arr
    (seed-major) order."""
    k = state.window.shape[1]
    nseeds = state.fwd.hi.shape[-1]
    his, los = [], []
    for si in range(nseeds):
        canon = u64.add(
            U64(state.fwd.hi[:, si], state.fwd.lo[:, si]),
            U64(state.rev.hi[:, si], state.rev.lo[:, si]),
        )
        for e in u64.extend_hashes(canon, k, num_hashes_per_seed):
            his.append(e.hi), los.append(e.lo)
    return U64(jnp.stack(his, -1), jnp.stack(los, -1))


@partial(jax.jit, static_argnames=("seeds",))
def roll_select(state: BlindSeedState, choice: jnp.ndarray,
                seeds: tuple[str, ...]) -> BlindSeedState:
    """Roll every walk by its per-lane chosen base code [B]."""
    return _roll(_all_taps(seeds), state, choice.astype(jnp.int32))


@partial(jax.jit, static_argnames=("seeds",))
def roll_back_select(state: BlindSeedState, choice: jnp.ndarray,
                     seeds: tuple[str, ...]) -> BlindSeedState:
    return _roll_back(_all_taps(seeds), state, choice.astype(jnp.int32))


@partial(jax.jit, static_argnames=("seeds", "num_hashes_per_seed"))
def roll_many(state: BlindSeedState, chars: jnp.ndarray,
              seeds: tuple[str, ...], num_hashes_per_seed: int = 1):
    """Replay [T, B] base streams; returns (final state, U64 [T, B, S*H])."""
    taps = _all_taps(seeds)

    def step(st, c):
        st = _roll(taps, st, c.astype(jnp.int32))
        return st, hashes_of(st, num_hashes_per_seed)

    return jax.lax.scan(step, state, chars)
