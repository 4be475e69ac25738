"""Packed Bloom filter over a read batch: build, query, merge.

The reference exists to feed exactly this consumer — btllib's Bloom
filters (reference include/nthash/nthash.hpp:56-58) — but leaves the
filter to the caller. Here the whole path is on device: hashes feed a
scatter into a presence array that packs to 1 bit per bucket (a 2^30-bit
filter is 128 MB of device memory), and queries are gathers.

Usage: python examples/bloom_filter.py [width_log2] (default 20; on a
GPU try 30 — the multi-gigabit btllib regime).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np

from nthash_tpu.models.bloom import (
    BloomFilter, contains, fill_ratio, insert, merge,
)
from nthash_tpu.ops.kmer_jnp import hash_kmers

K, NUM_HASHES = 25, 3
WIDTH_LOG2 = int(sys.argv[1]) if len(sys.argv) > 1 else 20

rng = np.random.default_rng(7)
reads = rng.integers(0, 4, size=(512, 100), dtype=np.uint8)

# build: one filter per half of the batch, then a lossless OR-merge
# (the same op a multi-chip run applies across devices via all-gather)
batch_hash = jax.jit(jax.vmap(lambda c: hash_kmers(c, K, NUM_HASHES)))
halves = []
for part in (reads[:256], reads[256:]):
    res = batch_hash(jnp.asarray(part))  # hashes U64 [B, W, H], valid [B, W]
    halves.append(insert(
        BloomFilter.zeros(WIDTH_LOG2), res.hashes, res.valid, WIDTH_LOG2))
bf = merge(*halves)

# query: every inserted k-mer must be present (no false negatives)
res = batch_hash(jnp.asarray(reads))
present = contains(bf, res.hashes, WIDTH_LOG2)
hits = int(jnp.sum(present & res.valid))
total = int(jnp.sum(res.valid))
assert hits == total, "a Bloom filter never has false negatives"

# negative controls: random k-mers should mostly miss at low fill
probe = hash_kmers(
    jnp.asarray(rng.integers(0, 4, size=20_000, dtype=np.uint8)),
    K, NUM_HASHES)
fp = int(jnp.sum(contains(bf, probe.hashes, WIDTH_LOG2) & probe.valid))
print(
    f"width 2^{WIDTH_LOG2}: inserted {total} k-mers, "
    f"fill {float(fill_ratio(bf)):.4f}, "
    f"0 false negatives, {fp}/{int(jnp.sum(probe.valid))} probe hits"
)
