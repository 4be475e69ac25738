"""Batched k-mer hashing engine in pure jax.numpy (portable: any backend).

Batched reformulation of ntHash's sequential iterator (reference
src/kmer.cpp:198-336): instead of one O(1) roll per call, a single
``lax.scan`` over sequence position rolls *every read in the batch* one base
per step. Per-step cost is O(1) and independent of k, so k=32 costs the
same as k=5. This is the engine off the GPU and the reference the Triton
kernel (ops/kmer_pallas.py) is tested against.

Key identities (derived from fwd/rev being XOR of independently-rotated
per-base seeds, reference src/kmer.cpp:43-73, 123-152):

  warm-up and steady-state share one recurrence by treating the outgoing
  base of not-yet-complete windows as N (zero seed):

    fwd_t = srol(fwd_{t-1}) ^ SEED[s_t] ^ srol^k(SEED[s_{t-k}])
    rev_t = sror(rev_{t-1} ^ SEED[comp(s_{t-k})]) ^ srol^(k-1)(SEED[comp(s_t)])

  with s_{t-k} = N for t < k. At step t >= k-1 the state equals the exact
  ntHash2 forward/reverse hash of window w = t-k+1.

N / invalid-base handling is pure masking: an invalid base contributes the
zero seed, and because roll-out exactly cancels roll-in, it corrupts only the
windows that contain it — which are masked invalid. The surviving positions
match NtHash's N-skip semantics (reference src/kmer.cpp:228-264) exactly.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import u64
from ..constants import COMP_CODE, SEEDS, srol_seed
from ..u64 import U64


class PlaneTables(NamedTuple):
    """The per-base constant tables for a given k (trace-time)."""

    fwd_in: tuple[int, ...]    # SEED[b]
    fwd_out: tuple[int, ...]   # srol^k(SEED[b])
    rev_in: tuple[int, ...]    # srol^(k-1)(SEED[comp(b)])
    rev_out: tuple[int, ...]   # SEED[comp(b)]
    rev_out_r: tuple[int, ...]  # sror(SEED[comp(b)]) — sror folded into the
    #                             table so the roll-out XOR commutes past it


def plane_tables(k: int) -> PlaneTables:
    from ..constants import sror1 as _sror1

    return PlaneTables(
        fwd_in=tuple(SEEDS[b] for b in range(5)),
        fwd_out=tuple(srol_seed(b, k) for b in range(5)),
        rev_in=tuple(srol_seed(COMP_CODE[b], k - 1) for b in range(5)),
        rev_out=tuple(SEEDS[COMP_CODE[b]] for b in range(5)),
        rev_out_r=tuple(_sror1(SEEDS[COMP_CODE[b]]) for b in range(5)),
    )


class KmerHashes(NamedTuple):
    """Hashes of every window of a [B, L] batch; W = L - k + 1.

    ``hashes`` holds canonical + nte64 extensions stacked on the last axis.
    Only entries with ``valid[b, w]`` are defined ntHash2 values.
    """

    fwd: U64      # [B, W]
    rev: U64      # [B, W]
    hashes: U64   # [B, W, num_hashes]
    valid: jnp.ndarray  # [B, W] bool


def window_valid(codes: jnp.ndarray, k: int) -> jnp.ndarray:
    """[..., L] codes -> [..., W] bool: no invalid base in window."""
    invalid = (codes >= 4).astype(jnp.int32)
    p = jnp.cumsum(invalid, axis=-1)
    total = p[..., k - 1 :]
    before = jnp.pad(p, [(0, 0)] * (p.ndim - 1) + [(1, 0)])[..., : p.shape[-1] - k + 1]
    return (total - before) == 0


def window_valid_tm(codes_tm: jnp.ndarray, k: int) -> jnp.ndarray:
    """Time-major variant: [L, R] codes -> [W, R] bool, no transpose
    (cumsum over the time axis; matches ``window_valid(codes_tm.T, k).T``
    without the relayout cost)."""
    invalid = (codes_tm >= 4).astype(jnp.int32)
    p = jnp.cumsum(invalid, axis=0)
    total = p[k - 1 :]
    before = jnp.pad(p, ((1, 0), (0, 0)))[: p.shape[0] - k + 1]
    return (total - before) == 0


def _roll_step(tabs: PlaneTables, state, xs):
    fwd, rev = state
    c_in, c_out = xs
    fwd = u64.xor(
        u64.xor(u64.srol1(fwd), u64.lookup5(c_in, tabs.fwd_in)),
        u64.lookup5(c_out, tabs.fwd_out),
    )
    rev = u64.xor(
        u64.sror1(u64.xor(rev, u64.lookup5(c_out, tabs.rev_out))),
        u64.lookup5(c_in, tabs.rev_in),
    )
    return (fwd, rev), (fwd, rev)


@partial(jax.jit, static_argnames=("k", "num_hashes"))
def hash_kmers(codes: jnp.ndarray, k: int, num_hashes: int = 1) -> KmerHashes:
    """Hash all k-mer windows of a batch of encoded reads.

    Args:
      codes: [B, L] (or [L]) uint8/int32 base codes (0-3 = ACGT, >=4 invalid).
      k: k-mer size (static).
      num_hashes: hashes per k-mer (canonical + nte64 extensions, static).

    Returns KmerHashes with [B, W] leaves (W = L - k + 1).
    """
    squeeze = codes.ndim == 1
    if squeeze:
        codes = codes[None]
    codes = codes.astype(jnp.int32)
    codes = jnp.where(codes > 4, 4, codes)
    b, length = codes.shape
    if k <= 0:
        raise ValueError("k must be greater than 0")
    if length < k:
        raise ValueError(f"sequence length ({length}) is smaller than k ({k})")

    tabs = plane_tables(k)
    in_codes = codes.T  # [L, B]
    out_codes = jnp.concatenate(
        [jnp.full((k, b), 4, jnp.int32), in_codes[: length - k]], axis=0
    )

    init = (U64.zeros((b,)), U64.zeros((b,)))
    _, (fwd_seq, rev_seq) = jax.lax.scan(
        partial(_roll_step, tabs), init, (in_codes, out_codes)
    )
    # steps k-1 .. L-1 hold windows 0 .. W-1; transpose [W, B] -> [B, W]
    fwd = U64(fwd_seq.hi[k - 1 :].T, fwd_seq.lo[k - 1 :].T)
    rev = U64(rev_seq.hi[k - 1 :].T, rev_seq.lo[k - 1 :].T)

    canon = u64.add(fwd, rev)
    ext = u64.extend_hashes(canon, k, num_hashes)
    hashes = U64(
        jnp.stack([e.hi for e in ext], axis=-1),
        jnp.stack([e.lo for e in ext], axis=-1),
    )
    valid = window_valid(codes, k)

    if squeeze:
        fwd = U64(fwd.hi[0], fwd.lo[0])
        rev = U64(rev.hi[0], rev.lo[0])
        hashes = U64(hashes.hi[0], hashes.lo[0])
        valid = valid[0]
    return KmerHashes(fwd, rev, hashes, valid)
