"""Batched stateful blind rolling: BlindNtHash on the device.

The reference's BlindNtHash (src/kmer.cpp:338-393) carries (fwd, rev, k-char
window) and is fed one base at a time — the de Bruijn graph traversal
primitive. Here that state is a pytree of [B]-vectored limb pairs plus a
[B, k] window, so thousands of independent graph walks advance in lockstep:

- ``roll_many``: replay [T, B] caller-fed base streams under ``lax.scan``
  (the "stateful carried hash state in a scan" capability).
- ``peek4``: hash all four possible extensions of every walk at once —
  the batched equivalent of probing peek('A'/'C'/'G'/'T').
- ``roll_select``: commit a per-walk chosen base.

All updates are the same bit-exact recurrences as the scalar facade.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import u64
from ..u64 import U64
from .kmer_jnp import PlaneTables, plane_tables


class BlindState(NamedTuple):
    """State of B independent blind rollers with a shared k."""

    fwd: U64            # [B]
    rev: U64            # [B]
    window: jnp.ndarray  # [B, k] int32 codes, window[:, 0] = oldest base
    pos: jnp.ndarray     # [B] int32 (parity with BlindNtHash::get_pos)


def init_state(windows: jnp.ndarray) -> BlindState:
    """Initialize from [B, k] code windows (hashes the window immediately,
    like the BlindNtHash ctor — no N handling, invalid codes hash as zero)."""
    from .kmer_jnp import hash_kmers

    windows = windows.astype(jnp.int32)
    b, k = windows.shape
    res = hash_kmers(windows, k, 1)
    fwd = U64(res.fwd.hi[:, 0], res.fwd.lo[:, 0])
    rev = U64(res.rev.hi[:, 0], res.rev.lo[:, 0])
    return BlindState(fwd, rev, windows, jnp.zeros(b, jnp.int32))


def _roll(tabs: PlaneTables, state: BlindState, c_in: jnp.ndarray) -> BlindState:
    c_out = state.window[:, 0]
    fwd = u64.xor(
        u64.xor(u64.srol1(state.fwd), u64.lookup5(c_in, tabs.fwd_in)),
        u64.lookup5(c_out, tabs.fwd_out),
    )
    rev = u64.xor(
        u64.xor(u64.sror1(state.rev), u64.lookup5(c_in, tabs.rev_in)),
        u64.lookup5(c_out, tabs.rev_out_r),
    )
    window = jnp.concatenate([state.window[:, 1:], c_in[:, None]], axis=1)
    return BlindState(fwd, rev, window, state.pos + 1)


def _roll_back(tabs: PlaneTables, state: BlindState, c_in: jnp.ndarray) -> BlindState:
    """Inverse roll (reference prev_forward/reverse_hash, kmer.cpp:104-114,
    184-194): remove the newest base, prepend c_in."""
    c_out = state.window[:, -1]
    fwd = u64.sror1(
        u64.xor(
            u64.xor(state.fwd, u64.lookup5(c_in, tabs.fwd_out)),
            u64.lookup5(c_out, tabs.fwd_in),
        )
    )
    rev = u64.xor(
        u64.xor(u64.srol1(state.rev), u64.lookup5(c_in, tabs.rev_in1)),
        u64.lookup5(c_out, tabs.rev_in_k),
    )
    window = jnp.concatenate([c_in[:, None], state.window[:, :-1]], axis=1)
    return BlindState(fwd, rev, window, state.pos - 1)


@partial(jax.jit, static_argnames=("num_hashes",))
def hashes_of(state: BlindState, num_hashes: int = 1) -> U64:
    """Current canonical + extended hashes, [B, num_hashes]."""
    k = state.window.shape[1]
    canon = u64.add(state.fwd, state.rev)
    ext = u64.extend_hashes(canon, k, num_hashes)
    return U64(
        jnp.stack([e.hi for e in ext], -1), jnp.stack([e.lo for e in ext], -1)
    )


@partial(jax.jit, static_argnames=("num_hashes",))
def roll_many(state: BlindState, chars: jnp.ndarray, num_hashes: int = 1):
    """Replay [T, B] base streams; returns (final state, hashes U64 [T, B, H])."""
    k = state.window.shape[1]
    tabs = _tables(k)

    def step(st, c):
        st = _roll(tabs, st, c.astype(jnp.int32))
        h = hashes_of(st, num_hashes)
        return st, h

    return jax.lax.scan(step, state, chars)


@jax.jit
def roll_select(state: BlindState, choice: jnp.ndarray) -> BlindState:
    """Roll every walk by its per-lane chosen base code [B]."""
    k = state.window.shape[1]
    return _roll(_tables(k), state, choice.astype(jnp.int32))


@jax.jit
def roll_back_select(state: BlindState, choice: jnp.ndarray) -> BlindState:
    k = state.window.shape[1]
    return _roll_back(_tables(k), state, choice.astype(jnp.int32))


@partial(jax.jit, static_argnames=("num_hashes",))
def peek4(state: BlindState, num_hashes: int = 1) -> U64:
    """Hashes of all four possible extensions, [B, 4, H] (DBG probing)."""
    k = state.window.shape[1]
    tabs = _tables(k)
    b = state.window.shape[0]
    outs = []
    for code in range(4):
        c = jnp.full((b,), code, jnp.int32)
        st = _roll(tabs, state, c)
        outs.append(hashes_of(st, num_hashes))
    return U64(
        jnp.stack([o.hi for o in outs], 1), jnp.stack([o.lo for o in outs], 1)
    )


class _ExtTables(NamedTuple):
    fwd_in: tuple
    fwd_out: tuple
    rev_in: tuple
    rev_out_r: tuple
    rev_in_k: tuple   # srol^k(SEED[comp(b)]) — prev_reverse incoming term
    rev_in1: tuple    # SEED[comp(b)] — prev_reverse outgoing term


def _tables(k: int) -> _ExtTables:
    from ..constants import COMP_CODE, SEEDS, srol_seed

    t = plane_tables(k)
    return _ExtTables(
        fwd_in=t.fwd_in,
        fwd_out=t.fwd_out,
        rev_in=t.rev_in,
        rev_out_r=t.rev_out_r,
        rev_in_k=tuple(srol_seed(COMP_CODE[b], k) for b in range(5)),
        rev_in1=tuple(SEEDS[COMP_CODE[b]] for b in range(5)),
    )
