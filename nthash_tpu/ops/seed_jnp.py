"""Batched spaced-seed ("ntmsm64") hashing engine in pure jax.numpy.

Batched reformulation of the reference's block-rolling kernel
(reference src/seed.cpp:130-207): because the spaced-seed hash is an XOR of
independently-rotated per-base seeds over the care positions only,

    fwd(w) = XOR_{i in care} srol^(k-1-i)(SEED[s[w+i]])
    rev(w) = XOR_{i in care} srol^(i)(SEED[comp(s[w+i])])

every window can be computed *directly* with one shifted-slice lookup + XOR
per care position — embarrassingly parallel over [B, W] with no sequential
recurrence at all. The block/monomer decomposition (reference
src/seed.cpp:19-66) reduces to the parity of coverage counts, which
``oracle.get_blocks`` + ``seed_positions_of`` reproduce exactly; the per-
position rotation planes are baked in as trace-time constants.

The reference's N-handling quirk (an N inside the window hashes as a zero
seed; see oracle.seed_nthash_positions) is automatic here: invalid codes
select the zero plane.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from .. import u64
from ..constants import COMP_CODE, SROL_PERIOD, srol_seed
from ..oracle import get_blocks, seed_positions_of
from ..u64 import U64


class SeedHashes(NamedTuple):
    """Spaced-seed hashes of every window; S seeds, W = L - k + 1 windows.

    ``hashes`` layout matches the reference hash_arr
    (seed-major: [..., s*num_hashes_per_seed + i]).
    """

    fwd: U64      # [B, W, S]
    rev: U64      # [B, W, S]
    hashes: U64   # [B, W, S * num_hashes_per_seed]
    valid: jnp.ndarray  # [B, W] bool (strict ACGTU validity of the window)


def care_positions(seeds: Sequence[str]) -> list[list[int]]:
    """Care positions per seed via the reference block decomposition."""
    blocks, monomers = get_blocks(list(seeds))
    return [seed_positions_of(b, m) for b, m in zip(blocks, monomers)]


# Rolling form (host-side trace helpers for the stateful facades and
# ops/blind_seed_scan.py): the spaced-seed hash is an XOR of
# independently-rotated per-base seeds over the care positions, so for
# each maximal care run [s, e) rolling the window by one base is exactly
# two edge updates:
#
#     fwd(w) = srol(fwd(w-1)) ^ srol^(k-e)(SEED[seq[w-1+e]])
#                             ^ srol^(k-s)(SEED[seq[w-1+s]])
#     rev(w) = sror(rev(w-1)) ^ srol^(e-1)(SEED[comp(seq[w-1+e])])
#                             ^ srol^(s-1)(SEED[comp(seq[w-1+s])])
#
# (the srol/sror exponents live in the order-1023 split-rotation group, so
# s-1 = -1 means srol^1022). There is no monomer special case and no
# care/ignore complement representation: every care run uses the same
# two-tap update, and the hash value is identical by XOR algebra.


class BlockTaps(NamedTuple):
    """Trace-time constants for one care run [s, e) of one seed."""

    off_in: int                 # tap offset from t for the entering edge: k - e
    off_out: int                # tap offset for the leaving edge: k - s
    fwd_in: tuple[int, ...]     # srol^(k-e)(SEED[b])
    fwd_out: tuple[int, ...]    # srol^(k-s)(SEED[b])
    rev_in: tuple[int, ...]     # srol^(e-1)(SEED[comp(b)])
    rev_out: tuple[int, ...]    # srol^(s-1)(SEED[comp(b)])


def care_runs(seed: str) -> list[tuple[int, int]]:
    """Maximal runs of '1' (care) positions in a pattern string."""
    runs, start = [], None
    for i, ch in enumerate(seed):
        if ch == "1" and start is None:
            start = i
        elif ch != "1" and start is not None:
            runs.append((start, i))
            start = None
    if start is not None:
        runs.append((start, len(seed)))
    if not runs:
        raise ValueError(f"seed pattern has no care positions: {seed!r}")
    return runs


def seed_taps(seed: str) -> list[BlockTaps]:
    k = len(seed)
    taps = []
    for s, e in care_runs(seed):
        taps.append(
            BlockTaps(
                off_in=k - e,
                off_out=k - s,
                fwd_in=tuple(srol_seed(c, k - e) for c in range(4)) + (0,),
                fwd_out=tuple(srol_seed(c, k - s) for c in range(4)) + (0,),
                rev_in=tuple(
                    srol_seed(COMP_CODE[c], (e - 1) % SROL_PERIOD)
                    for c in range(4)
                )
                + (0,),
                rev_out=tuple(
                    srol_seed(COMP_CODE[c], (s - 1) % SROL_PERIOD)
                    for c in range(4)
                )
                + (0,),
            )
        )
    return taps



@partial(jax.jit, static_argnames=("seeds", "num_hashes_per_seed"))
def hash_kmers_seeds(
    codes: jnp.ndarray,
    seeds: tuple[str, ...],
    num_hashes_per_seed: int = 1,
) -> SeedHashes:
    """Hash all windows of a [B, L] batch under each spaced-seed pattern.

    Args:
      codes: [B, L] (or [L]) base codes.
      seeds: tuple of '1'/'0' pattern strings, all of length k (static).
      num_hashes_per_seed: nte64 hashes per seed (static).
    """
    squeeze = codes.ndim == 1
    if squeeze:
        codes = codes[None]
    codes = codes.astype(jnp.int32)
    codes = jnp.where(codes > 4, 4, codes)
    b, length = codes.shape
    k = len(seeds[0])
    if any(len(s) != k for s in seeds):
        raise ValueError("all seed strings must have equal length k")
    if length < k:
        raise ValueError(f"sequence length ({length}) is smaller than k ({k})")
    w = length - k + 1

    fwd_list, rev_list, hash_list = [], [], []
    for positions in care_positions(seeds):
        fwd = U64.zeros((b, w))
        rev = U64.zeros((b, w))
        for i in positions:
            window_codes = jax.lax.slice_in_dim(codes, i, i + w, axis=1)
            fwd_plane = tuple(srol_seed(c, k - 1 - i) for c in range(4)) + (0,)
            rev_plane = tuple(srol_seed(COMP_CODE[c], i) for c in range(4)) + (0,)
            fwd = u64.xor(fwd, u64.lookup5(window_codes, fwd_plane))
            rev = u64.xor(rev, u64.lookup5(window_codes, rev_plane))
        fwd_list.append(fwd)
        rev_list.append(rev)
        canon = u64.add(fwd, rev)
        hash_list.extend(u64.extend_hashes(canon, k, num_hashes_per_seed))

    fwd = U64(
        jnp.stack([f.hi for f in fwd_list], axis=-1),
        jnp.stack([f.lo for f in fwd_list], axis=-1),
    )
    rev = U64(
        jnp.stack([r.hi for r in rev_list], axis=-1),
        jnp.stack([r.lo for r in rev_list], axis=-1),
    )
    hashes = U64(
        jnp.stack([h.hi for h in hash_list], axis=-1),
        jnp.stack([h.lo for h in hash_list], axis=-1),
    )

    invalid = (codes >= 4).astype(jnp.int32)
    p = jnp.cumsum(invalid, axis=-1)
    before = jnp.pad(p, [(0, 0), (1, 0)])[:, : length - k + 1]
    valid = (p[:, k - 1 :] - before) == 0

    if squeeze:
        fwd = U64(fwd.hi[0], fwd.lo[0])
        rev = U64(rev.hi[0], rev.lo[0])
        hashes = U64(hashes.hi[0], hashes.lo[0])
        valid = valid[0]
    return SeedHashes(fwd, rev, hashes, valid)
