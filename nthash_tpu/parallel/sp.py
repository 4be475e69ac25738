"""Sequence parallelism: one genome-scale sequence sharded over devices.

The reference's NtHash is strictly sequential in pos (src/kmer.cpp:246-264).
Because the hash is position-decomposable (an XOR of independently-rotated
per-base terms, src/kmer.cpp:43-73), a length-L sequence can be chunked
across devices with only a (k-1)-base halo from the right neighbor — the
ring-attention moral equivalent for rolling hashes (SURVEY.md §5). The halo
moves with one ppermute; no sequential dependency crosses devices.

Within a device, the chunk is reshaped into **overlapping pseudo-reads**
[C/T, T + k - 1] (each row carries the next row's first k-1 bases, the same
halo trick one level down), so the batched engines hash T windows per row
fully vectorized — the Triton kernel on a GPU, the batched jnp scan
elsewhere (nthash_tpu.backend decides). One batch-1 scan over the whole
chunk would take one serial step per base.

Device d owns global windows [d*C, d*C + C); the last device's top k-1
windows run off the sequence end and are masked invalid via halo padding
with invalid codes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .. import backend
from ..ops.kmer_jnp import window_valid
from ..ops.seed_jnp import hash_kmers_seeds
from ..u64 import U64
from .mesh import SEQ_AXIS


def shard_sequence(
    codes: jnp.ndarray, mesh: Mesh, k: int | None = None,
    tile: int | None = None,
) -> jnp.ndarray:
    """Place a [L] sequence sharded over the seq axis.

    With ``k`` given, any length is accepted: the sequence is padded with
    invalid codes up to a multiple of ``n_devices * tile`` (so every
    device chunk divides evenly into >=k-1-window pseudo-read tiles —
    real chromosome lengths are never multiples of the mesh size).
    Padded windows carry an invalid base, so they are masked exactly like
    the off-end windows; consumers that honor ``valid`` need no change,
    and window w < L-k+1 is unaffected. Without ``k`` (legacy), L must
    already be divisible by n_devices.
    """
    n = mesh.shape[SEQ_AXIS]
    if k is not None:
        t0 = max(tile or 256, k - 1, 1)
        quantum = n * t0
        pad = (-codes.shape[0]) % quantum
        if pad:
            codes = jnp.pad(codes, (0, pad), constant_values=4)
    elif codes.shape[0] % n:
        raise ValueError(
            f"sequence length {codes.shape[0]} is not divisible by the "
            f"{n}-device seq mesh; pass k= to shard_sequence to pad"
        )
    return jax.device_put(codes, NamedSharding(mesh, P(SEQ_AXIS)))


def _halo_extend(chunk: jnp.ndarray, k: int, n: int) -> jnp.ndarray:
    """Append the right neighbor's first k-1 codes (ring ppermute);
    the last device gets invalid codes so its off-end windows mask out."""
    halo_src = chunk[: k - 1]
    perm = [(i, (i - 1) % n) for i in range(n)]
    halo = jax.lax.ppermute(halo_src, SEQ_AXIS, perm)
    is_last = jax.lax.axis_index(SEQ_AXIS) == n - 1
    halo = jnp.where(is_last, jnp.full_like(halo, 4), halo)
    return jnp.concatenate([chunk, halo])  # [C + k - 1]


def pick_tile(c: int, k: int, tile: int | None = None) -> int:
    """Pseudo-read window count: a divisor of the chunk that is >= k-1
    (``pseudo_reads`` pads each row by t-k+1, so t < k-1 would be a
    negative pad — ADVICE r3), preferring the largest such divisor
    <= ``tile`` (default 256) and falling back to the smallest one above.
    """
    lo = max(k - 1, 1)
    if c < lo:
        raise ValueError(
            f"per-device chunk ({c}) is smaller than k-1 ({k - 1}); "
            "use fewer devices or pad the sequence (shard_sequence with k=)"
        )
    divisors = set()
    i = 1
    while i * i <= c:
        if c % i == 0:
            divisors.update((i, c // i))
        i += 1
    t0 = min(tile or 256, c)
    best_below = max((d for d in divisors if lo <= d <= t0), default=None)
    if best_below is not None:
        return best_below
    return min(d for d in divisors if d >= lo)


def pseudo_reads(ext: jnp.ndarray, k: int, t: int) -> jnp.ndarray:
    """[C + k - 1] halo-extended chunk -> overlapping rows [C/t, t + k - 1].

    Row i covers bases [i*t, (i+1)*t + k - 1): its t windows are the
    chunk's global windows [i*t, (i+1)*t). The per-row (k-1)-base overlap
    is the same halo idea as the cross-device exchange, one level down.
    """
    c = ext.shape[0] - (k - 1)
    rows = c // t
    main = ext[:c].reshape(rows, t)
    padded = jnp.pad(ext, (0, t - k + 1), constant_values=4)
    tails = padded[t:].reshape(rows, t)[:, : k - 1]
    return jnp.concatenate([main, tails], axis=1)


def _hash_pseudo(pseudo, k, num_hashes, engine, interpret):
    """[rows, t+k-1] -> (list of ``num_hashes`` U64 [rows*t], valid
    [rows*t]): one flat array per hash, in sequence order."""
    res, valid = backend.hash_windows_tm(
        pseudo, k, num_hashes, engine=engine, interpret=interpret)
    # [t, rows] per hash -> [rows, t] -> flat [C]
    hashes = [U64(h.hi.T.reshape(-1), h.lo.T.reshape(-1)) for h in res]
    return hashes, valid.T.reshape(-1)


@partial(
    jax.jit,
    static_argnames=("k", "num_hashes", "mesh", "engine", "tile", "interpret"),
)
def hash_long_sequence(
    codes: jnp.ndarray,
    k: int,
    num_hashes: int,
    mesh: Mesh,
    *,
    engine: str = "auto",
    tile: int | None = None,
    interpret: bool = False,
):
    """Hash every window of a device-sharded long sequence.

    Args:
      codes: [L] base codes, sharded over the "seq" mesh axis.
      engine: "auto" (the Triton kernel on a GPU, jnp elsewhere) | "jnp"
        | "pallas" (GPU only; ``interpret=True`` runs it in the Pallas
        interpreter for tests).
      tile: windows per pseudo-read (default 256; clipped/adjusted to
        divide the per-device chunk).

    Returns (list of ``num_hashes`` U64 with [L] arrays sharded over seq,
    valid [L] sharded): entry w of hash i is nte64 hash i of window
    [w, w+k); the trailing k-1 entries (which would run off the end) are
    masked invalid, so every device owns exactly L/n entries.
    """
    n = mesh.shape[SEQ_AXIS]
    c = codes.shape[0] // n
    t = pick_tile(c, k, tile)

    def local(chunk):
        ext = _halo_extend(chunk, k, n)
        hashes, valid = _hash_pseudo(
            pseudo_reads(ext, k, t), k, num_hashes, engine, interpret
        )
        return tuple(h.hi for h in hashes), tuple(h.lo for h in hashes), valid

    his, los, valid = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(SEQ_AXIS),),
        out_specs=(
            tuple(P(SEQ_AXIS) for _ in range(num_hashes)),
            tuple(P(SEQ_AXIS) for _ in range(num_hashes)),
            P(SEQ_AXIS),
        ),
        check_vma=False,
    )(codes)
    return [U64(h, lo) for h, lo in zip(his, los)], valid


@partial(
    jax.jit,
    static_argnames=("seeds", "num_hashes_per_seed", "mesh", "tile"),
)
def hash_long_sequence_seeds(
    codes: jnp.ndarray,
    seeds: tuple[str, ...],
    num_hashes_per_seed: int,
    mesh: Mesh,
    *,
    tile: int | None = None,
):
    """Spaced-seed hash of every window of a device-sharded long sequence.

    Same halo + pseudo-read scheme as :func:`hash_long_sequence` (the
    spaced-seed hash is also position-decomposable), with the direct
    per-window XLA engine (ops/seed_jnp.py). Returns (list of S*H U64
    with [L] arrays sharded over seq, in reference hash_arr order, valid
    [L]): entry w is the window starting at w; the trailing k-1 off-end
    entries are masked invalid.
    """
    n = mesh.shape[SEQ_AXIS]
    k = len(seeds[0])
    c = codes.shape[0] // n
    t = pick_tile(c, k, tile)
    nout = len(seeds) * num_hashes_per_seed

    def local(chunk):
        ext = _halo_extend(chunk, k, n)
        pseudo = pseudo_reads(ext, k, t)
        res = hash_kmers_seeds(pseudo, seeds, num_hashes_per_seed)
        his = tuple(res.hashes.hi[..., i].reshape(-1) for i in range(nout))
        los = tuple(res.hashes.lo[..., i].reshape(-1) for i in range(nout))
        valid = window_valid(pseudo.astype(jnp.int32), k).reshape(-1)
        return his, los, valid

    his, los, valid = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(SEQ_AXIS),),
        out_specs=(
            tuple(P(SEQ_AXIS) for _ in range(nout)),
            tuple(P(SEQ_AXIS) for _ in range(nout)),
            P(SEQ_AXIS),
        ),
        check_vma=False,
    )(codes)
    return [U64(h, lo) for h, lo in zip(his, los)], valid
