"""Bloom filter model: packed-word insert/query/merge + distributed union."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from nthash_tpu.models import bloom
from nthash_tpu.ops.kmer_jnp import hash_kmers

K, H, WL = 9, 3, 14


def _hash(codes):
    return hash_kmers(jnp.asarray(codes), K, H)


def test_packed_memory_layout():
    bf = bloom.BloomFilter.zeros(WL)
    # 1 bit per bucket: width/32 uint32 words (round 1 spent 32x this)
    assert bf.words.dtype == jnp.uint32
    assert bf.words.size == (1 << WL) // 32
    assert bf.width == 1 << WL


def test_insert_then_contains(rng):
    codes = rng.integers(0, 4, size=(8, 60), dtype=np.uint8)
    res = _hash(codes)
    bf = bloom.insert(bloom.BloomFilter.zeros(WL), res.hashes, res.valid, WL)
    assert bool(jnp.all(bloom.contains(bf, res.hashes, WL)))


def test_absent_kmers_mostly_miss(rng):
    a = rng.integers(0, 4, size=(4, 60), dtype=np.uint8)
    b = rng.integers(0, 4, size=(4, 60), dtype=np.uint8)
    ra, rb = _hash(a), _hash(b)
    bf = bloom.insert(bloom.BloomFilter.zeros(WL), ra.hashes, ra.valid, WL)
    hits = np.asarray(bloom.contains(bf, rb.hashes, WL))
    # fill ratio is tiny (~208*3/16384); P(false positive) = ratio^3 << 1%
    assert hits.mean() < 0.05


def test_invalid_windows_not_inserted(rng):
    codes = np.full((1, 30), 4, dtype=np.uint8)  # all-N read
    res = _hash(codes)
    bf = bloom.insert(bloom.BloomFilter.zeros(WL), res.hashes, res.valid, WL)
    assert int(bloom.count_set_bits(bf)) == 0


def test_merge_is_union(rng):
    a = rng.integers(0, 4, size=(2, 40), dtype=np.uint8)
    b = rng.integers(0, 4, size=(2, 40), dtype=np.uint8)
    ra, rb = _hash(a), _hash(b)
    bfa = bloom.insert(bloom.BloomFilter.zeros(WL), ra.hashes, ra.valid, WL)
    bfb = bloom.insert(bloom.BloomFilter.zeros(WL), rb.hashes, rb.valid, WL)
    merged = bloom.merge(bfa, bfb)
    assert bool(jnp.all(bloom.contains(merged, ra.hashes, WL)))
    assert bool(jnp.all(bloom.contains(merged, rb.hashes, WL)))
    assert int(bloom.count_set_bits(merged)) <= int(
        bloom.count_set_bits(bfa)
    ) + int(bloom.count_set_bits(bfb))


def test_distributed_union(rng):
    import jax
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nthash_tpu.parallel.mesh import READS_AXIS, device_mesh

    mesh = device_mesh(4)
    codes = rng.integers(0, 4, size=(8, 40), dtype=np.uint8)
    sharded = jax.device_put(
        jnp.asarray(codes), NamedSharding(mesh, P(READS_AXIS, None))
    )

    def local(local_codes):
        res = hash_kmers(local_codes, K, H)
        bf = bloom.insert(bloom.BloomFilter.zeros(WL), res.hashes, res.valid, WL)
        return bloom.union_across(bf.words, READS_AXIS)

    words = shard_map(
        local, mesh=mesh, in_specs=(P(READS_AXIS, None),), out_specs=P(),
        check_vma=False,
    )(sharded)
    merged = bloom.BloomFilter(words)
    res = _hash(codes)
    assert bool(jnp.all(bloom.contains(merged, res.hashes, WL)))


def test_fill_ratio():
    words = np.zeros((1 << WL) // 32, dtype=np.uint32)
    words[0] = 0b111  # 3 set bits
    bf = bloom.BloomFilter(jnp.asarray(words))
    assert float(bloom.fill_ratio(bf)) == pytest.approx(3 / (1 << WL))
    assert int(bloom.count_set_bits(bf)) == 3


def test_scatter_insert_has_no_int32_width_transient():
    """Insertion's transient presence array must be int8 (1 byte/bucket):
    an int32 transient costs 4 bytes per bucket at exactly the widths
    where the packed format matters (4 GB at 2^30). Asserted via the
    compiled executable's temp allocation."""
    import jax

    wlog = 16
    width = 1 << wlog
    from nthash_tpu.u64 import U64

    h = U64(jnp.zeros((64, 2), jnp.uint32), jnp.zeros((64, 2), jnp.uint32))
    v = jnp.ones((64,), bool)

    f = jax.jit(lambda words, hh, vv: bloom.insert(
        bloom.BloomFilter(words), hh, vv, wlog).words)
    stats = f.lower(
        bloom.BloomFilter.zeros(wlog).words, h, v
    ).compile().memory_analysis()
    assert stats is not None
    # int8 presence + packing slack stays well under 2 bytes/bucket; an
    # int32 transient alone is 4*width
    assert stats.temp_size_in_bytes < 2 * width, stats.temp_size_in_bytes
