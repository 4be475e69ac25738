"""Scatter ingestion into count sketches and packed Bloom filters, and the
packed Bloom bit layout users persist."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from nthash_tpu.models import bloom
from nthash_tpu.models import sketch as cms


@pytest.mark.parametrize("width_log2", [4, 10, 14, 17])
def test_scatter_counts_match_bincount(rng, width_log2):
    width = 1 << width_log2
    idx = rng.integers(0, width, size=(3, 5000)).astype(np.int32)
    idx[:, ::7] = width  # invalid-window sentinel
    got = np.asarray(cms.scatter_counts(jnp.asarray(idx), width_log2))
    for r in range(3):
        keep = idx[r][idx[r] < width]
        assert np.array_equal(got[r], np.bincount(keep, minlength=width))


def test_update_from_buckets_drops_sentinel_and_accumulates(rng):
    wl = 8
    sk = cms.CountMinSketch.zeros(2, wl)
    bucks = [jnp.asarray(rng.integers(0, (1 << wl) + 1, size=(7, 9)),
                         jnp.int32) for _ in range(2)]
    once = cms.update_from_buckets(sk, bucks, emitted_width_log2=wl)
    twice = cms.update_from_buckets(once, bucks)
    for r in range(2):
        b = np.asarray(bucks[r]).reshape(-1)
        exp = np.bincount(b[b < 1 << wl], minlength=1 << wl)
        assert np.array_equal(np.asarray(once.rows[r]), exp)
        assert np.array_equal(np.asarray(twice.rows[r]), 2 * exp)
    with pytest.raises(ValueError, match="emitted at width"):
        cms.update_from_buckets(sk, bucks, emitted_width_log2=wl - 1)
    with pytest.raises(ValueError, match="bucket arrays"):
        cms.update_from_buckets(sk, bucks[:1])


def test_sketch_update_matches_bincount(rng):
    from nthash_tpu.ops.kmer_jnp import hash_kmers

    codes = rng.integers(0, 5, size=(4, 30), dtype=np.uint8)
    res = hash_kmers(jnp.asarray(codes), 9, 3)
    sk = cms.update(cms.CountMinSketch.zeros(3, 11), res.hashes, res.valid, 11)
    lo = np.asarray(res.hashes.lo) & ((1 << 11) - 1)
    v = np.asarray(res.valid)
    for r in range(3):
        assert np.array_equal(np.asarray(sk.rows[r]),
                              np.bincount(lo[..., r][v], minlength=1 << 11))


# (bucket, word, bit): bucket b -> word ((b >> 12) << 7) | (b & 127), bit
# (b >> 7) & 31. Persisted filters depend on this never changing.
LAYOUT = [
    (0, 0, 0),
    (1, 1, 0),
    (127, 127, 0),
    (128, 0, 1),
    (4095, 127, 31),
    (4096, 128, 0),
    (0x12345, 0x945, 6),
    ((1 << 30) - 1, (1 << 25) - 1, 31),
]


def test_bloom_word_bit_layout_is_pinned():
    for b, word, bit in LAYOUT:
        assert int(bloom.word_index(b)) == word, b
        assert int(bloom.bit_index(b)) == bit, b
    b = np.array([x[0] for x in LAYOUT], np.int64)
    assert np.array_equal(bloom.word_index(b), [x[1] for x in LAYOUT])
    assert np.array_equal(bloom.bit_index(b), [x[2] for x in LAYOUT])


def test_presence_words_pack_in_layout(rng):
    wl = 14
    idx = rng.integers(0, 1 << wl, size=3000).astype(np.int32)
    idx[::5] = 1 << wl  # sentinel
    got = np.asarray(bloom.presence_words(jnp.asarray(idx), wl))
    exp = np.zeros(1 << (wl - 5), np.uint32)
    keep = idx[idx < 1 << wl]
    np.bitwise_or.at(exp, bloom.word_index(keep),
                     np.uint32(1) << bloom.bit_index(keep).astype(np.uint32))
    assert np.array_equal(got, exp)


def test_insert_from_buckets_matches_insert(rng):
    from nthash_tpu import backend
    from nthash_tpu.ops.kmer_jnp import hash_kmers

    wl = 13
    codes = rng.integers(0, 5, size=(5, 25), dtype=np.uint8)
    res = hash_kmers(jnp.asarray(codes), 7, 3)
    a = bloom.insert(bloom.BloomFilter.zeros(wl), res.hashes, res.valid, wl)
    b = bloom.insert_from_buckets(
        bloom.BloomFilter.zeros(wl),
        backend.bucket_rows(jnp.asarray(codes), 7, 3, wl),
        emitted_width_log2=wl)
    assert np.array_equal(np.asarray(a.words), np.asarray(b.words))
    assert bool(jnp.all(bloom.contains(b, res.hashes, wl)[res.valid]))
    with pytest.raises(ValueError, match="emitted at width"):
        bloom.insert_from_buckets(bloom.BloomFilter.zeros(wl), [],
                                  emitted_width_log2=wl + 1)
