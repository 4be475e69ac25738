"""Count-min sketch over k-mer hashes — the downstream consumer model.

The reference's ecosystem consumes ntHash values in Bloom filters / count
sketches (reference include/nthash/nthash.hpp:56-58 points at btllib). This
module provides the device equivalent: a count-min sketch whose rows are
indexed by the nte64 extended hashes and merged across devices with a single
psum (the all-reduce the reference lacks, SURVEY.md §2.7).

Ingestion is one XLA scatter-add per row, which the GPU runs as atomic
adds; out-of-range indices (the invalid-window sentinel ``width``) are
dropped by ``mode="drop"``.

The sketch is the "trainable state" of the flagship pipeline: per batch,
update = histogram of every valid window's hashes; merge = psum.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..u64 import U64


class CountMinSketch(NamedTuple):
    """rows[r, b]: count of (hash_r mod width) == b. width = 2**width_log2."""

    rows: jnp.ndarray  # [num_rows, width] int32

    @staticmethod
    def zeros(num_rows: int, width_log2: int) -> "CountMinSketch":
        return CountMinSketch(
            jnp.zeros((num_rows, 1 << width_log2), dtype=jnp.int32)
        )

    @property
    def width(self) -> int:
        return self.rows.shape[1]


def buckets(hashes: U64, width_log2: int) -> jnp.ndarray:
    """Bucket index per hash: the low ``width_log2`` bits (width <= 2^32)."""
    mask = jnp.uint32((1 << width_log2) - 1)
    return (hashes.lo & mask).astype(jnp.int32)


def scatter_counts(idx: jnp.ndarray, width_log2: int) -> jnp.ndarray:
    """[rows, N] int32 bucket indices -> [rows, 2**width_log2] int32
    counts. Indices outside [0, width) — the invalid-window sentinel —
    are dropped."""
    width = 1 << width_log2
    return jnp.stack([
        jnp.zeros(width, jnp.int32).at[row].add(1, mode="drop")
        for row in idx
    ])


def update(
    sketch: CountMinSketch,
    hashes: U64,
    valid: jnp.ndarray,
    width_log2: int,
) -> CountMinSketch:
    """Count every valid window's hashes into the sketch.

    hashes: U64 with arrays [..., num_rows] (last axis = hash index),
    valid: bool of hashes.shape[:-1].
    """
    num_rows = sketch.rows.shape[0]
    idx = buckets(hashes, width_log2).reshape(-1, num_rows)  # [N, R]
    idx = jnp.where(valid.reshape(-1, 1), idx, jnp.int32(1 << width_log2))
    return CountMinSketch(sketch.rows + scatter_counts(idx.T, width_log2))


def update_from_buckets(
    sketch: CountMinSketch,
    buckets,
    *,
    emitted_width_log2: int | None = None,
) -> CountMinSketch:
    """Ingest pre-bucketed indices from the fused hash kernel.

    buckets: list of ``num_rows`` int32 arrays (any matching shape), as
    produced by ``hash_kmers_tm(..., emit_buckets=width_log2)`` — row r of
    the sketch counts array r. Validity is already fused: invalid windows
    carry the out-of-range sentinel ``width`` and are dropped. This is the
    fast path of the counting pipeline (no 64-bit hash ever reaches device
    memory).

    Pass ``emitted_width_log2`` (the ``emit_buckets`` value used at the
    hash kernel) to guard against width drift: buckets emitted at a
    *smaller* width would silently count their invalid-window sentinel as
    a real bucket of the wider sketch.
    """
    num_rows, width = sketch.rows.shape
    if len(buckets) != num_rows:
        raise ValueError(
            f"got {len(buckets)} bucket arrays for {num_rows} sketch rows"
        )
    width_log2 = width.bit_length() - 1
    if emitted_width_log2 is not None and emitted_width_log2 != width_log2:
        raise ValueError(
            f"buckets were emitted at width 2**{emitted_width_log2} but the "
            f"sketch width is 2**{width_log2}"
        )
    idx = jnp.stack([b.reshape(-1) for b in buckets])
    return CountMinSketch(sketch.rows + scatter_counts(idx, width_log2))


def query(sketch: CountMinSketch, hashes: U64, width_log2: int) -> jnp.ndarray:
    """Count-min estimate: min over rows of the bucket counts."""
    idx = buckets(hashes, width_log2)  # [..., R]
    num_rows = sketch.rows.shape[0]
    per_row = [
        jnp.take(sketch.rows[r], idx[..., r], axis=0) for r in range(num_rows)
    ]
    return jnp.min(jnp.stack(per_row, axis=-1), axis=-1)


def query_rows(sketch: CountMinSketch, hashes, width_log2: int) -> jnp.ndarray:
    """Count-min estimate for the time-major layout: ``hashes`` is a list
    of ``num_rows`` U64 (any common shape, e.g. [W, B]); returns estimates
    of that shape. Same math as :func:`query` for the per-hash list
    layout."""
    num_rows = sketch.rows.shape[0]
    if len(hashes) != num_rows:
        raise ValueError(
            f"got {len(hashes)} hash arrays for {num_rows} sketch rows"
        )
    est = None
    for r, h in enumerate(hashes):
        got = jnp.take(sketch.rows[r], buckets(h, width_log2), axis=0)
        est = got if est is None else jnp.minimum(est, got)
    return est


def merge(a: CountMinSketch, b: CountMinSketch) -> CountMinSketch:
    """Sketches are linear: merging is elementwise addition."""
    return CountMinSketch(a.rows + b.rows)
