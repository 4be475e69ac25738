"""Bloom filter over k-mer hashes — the reference ecosystem's primary consumer.

ntHash exists to feed Bloom filters (reference include/nthash/nthash.hpp:56-58
points at btllib; the nte64 multi-hash extension exists precisely to derive
the h independent index functions a Bloom filter needs). This is the
device equivalent, **bit-packed**: 1 bit per bucket, stored as uint32
words (a 2^30-bit filter is 128 MB of device memory).

Insertion is a scatter-OR. XLA has no scatter-OR, so insertion scatters
into a transient presence array (``PRESENCE_DTYPE``, one element per
bucket; the GPU runs the scatter as atomics) and packs it into words.

Bit layout: bucket b lives in word :func:`word_index` (b) at bit
:func:`bit_index` (b) — 4096-bucket tiles of 32 rows x 128 columns, each
column packing into one word. Users persist filters in this layout, so it
never changes. Queries are gathers + bit tests. Cross-device merge is a
bitwise OR (one all_gather).

False-positive tuning: m = 2**width_log2 bits, optimal h ~= (m/n) ln 2.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..u64 import U64

_MIN_WIDTH_LOG2 = 12  # the packed bijection tiles (width/4096, 32, 128)

#: Element type of the transient presence array that insertion scatters
#: into before packing: 1 byte per bucket (1 GB at 2^30). The GPU has no
#: 8-bit atomic, so the int8 scatter-max is slower than an int32 one, but at
#: 2^30 only 1.2x, and 1.25x slower than the count scatter-add at the same
#: width, while int32 would cost 4 GB (PERF.md, Bring-up on H100).
PRESENCE_DTYPE = jnp.int8


def word_index(bucket):
    """Packed-word bijection: bucket b lives in word
    ``((b >> 12) << 7) | (b & 127)`` at bit ``(b >> 7) & 31`` (32 rows of
    a 4096-bucket tile pack into one word per column)."""
    return ((bucket >> 12) << 7) | (bucket & 127)


def bit_index(bucket):
    return (bucket >> 7) & 31


class BloomFilter(NamedTuple):
    """words[w]: 32 bucket-presence bits per uint32 word (1 bit/bucket)."""

    words: jnp.ndarray  # [width / 32] uint32

    @staticmethod
    def zeros(width_log2: int) -> "BloomFilter":
        if width_log2 < _MIN_WIDTH_LOG2:
            raise ValueError(
                f"width_log2 ({width_log2}) must be >= {_MIN_WIDTH_LOG2}"
            )
        return BloomFilter(jnp.zeros(1 << (width_log2 - 5), dtype=jnp.uint32))

    @property
    def width(self) -> int:
        return self.words.shape[0] * 32


def _indices(hashes: U64, width_log2: int) -> jnp.ndarray:
    """Bucket per hash: low width_log2 bits (hashes are uniform uint64)."""
    mask = jnp.uint32((1 << width_log2) - 1)
    return (hashes.lo & mask).astype(jnp.int32)


def pack_presence(presence: jnp.ndarray) -> jnp.ndarray:
    """[width] {0,1} -> packed uint32 [width/32] in word_index/bit_index
    order: bucket b = q*4096 + r*128 + j -> bit r of word q*128 + j."""
    width = presence.shape[0]
    p = presence.astype(jnp.uint32).reshape(width // 4096, 32, 128)
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, :, None]
    return jnp.sum(p << shifts, axis=1).reshape(-1)


def presence_words(idx: jnp.ndarray, width_log2: int) -> jnp.ndarray:
    """Packed words with the bit of every index in [0, 2**width_log2) set;
    other indices (the invalid-window sentinel) are dropped."""
    presence = (
        jnp.zeros(1 << width_log2, PRESENCE_DTYPE)
        .at[idx]
        .max(PRESENCE_DTYPE(1), mode="drop")
    )
    return pack_presence(presence)


def insert(bf: BloomFilter, hashes: U64, valid: jnp.ndarray,
           width_log2: int) -> BloomFilter:
    """Set the bit of every valid window's every hash.

    hashes: U64 [..., H] (H = hash functions per k-mer); valid: bool of
    hashes.shape[:-1].
    """
    idx = jnp.where(valid[..., None], _indices(hashes, width_log2),
                    jnp.int32(1 << width_log2))
    return BloomFilter(bf.words | presence_words(idx.reshape(-1), width_log2))


def insert_from_buckets(
    bf: BloomFilter, buckets, *, emitted_width_log2: int | None = None,
) -> BloomFilter:
    """Ingest pre-bucketed indices from the fused hash kernel.

    buckets: list of int32 arrays from ``hash_kmers_tm(..., emit_buckets=
    width_log2)`` with width matching the filter. Invalid windows carry
    the out-of-range sentinel and are dropped. Pass
    ``emitted_width_log2`` (the ``emit_buckets`` value used) to guard
    against width drift — buckets emitted at a smaller width would
    silently insert their sentinel as a real bit of the wider filter.
    """
    width_log2 = (bf.words.shape[0] * 32).bit_length() - 1
    if emitted_width_log2 is not None and emitted_width_log2 != width_log2:
        raise ValueError(
            f"buckets were emitted at width 2**{emitted_width_log2} but the "
            f"filter width is 2**{width_log2}"
        )
    idx = jnp.concatenate([b.reshape(-1) for b in buckets])
    return BloomFilter(bf.words | presence_words(idx, width_log2))


def contains(bf: BloomFilter, hashes: U64, width_log2: int) -> jnp.ndarray:
    """Membership: all H bits set. Returns bool of hashes.shape[:-1]."""
    b = _indices(hashes, width_log2)
    got = jnp.take(bf.words, word_index(b), axis=0)
    bit = (got >> bit_index(b).astype(jnp.uint32)) & 1
    return jnp.all(bit > 0, axis=-1)


def merge(a: BloomFilter, b: BloomFilter) -> BloomFilter:
    """Union (bitwise OR)."""
    return BloomFilter(a.words | b.words)


def union_across(words: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Cross-device union inside shard_map: one all_gather, then OR-fold
    the device axis (OR is not linear, so no psum trick applies to packed
    words; the gather moves width/32 * n_dev words — negligible)."""
    gathered = jax.lax.all_gather(words, axis_name)  # [n_dev, width/32]
    return jax.lax.reduce(
        gathered, jnp.uint32(0), jax.lax.bitwise_or, dimensions=(0,)
    )


def count_set_bits(bf: BloomFilter) -> jnp.ndarray:
    """Total set bits (popcount over words)."""
    return jnp.sum(jax.lax.population_count(bf.words).astype(jnp.int32))


def fill_ratio(bf: BloomFilter) -> jnp.ndarray:
    """Fraction of set bits (false-positive rate ~= ratio**H)."""
    pc = jax.lax.population_count(bf.words).astype(jnp.float32)
    return jnp.sum(pc) / bf.width
