#!/usr/bin/env python
"""Batched de Bruijn graph probing — the BlindNtHash use-case on the device.

The reference's BlindNtHash probes one graph walk at a time with
peek('A'/'C'/'G'/'T') (reference src/kmer.cpp:377-384). Here 4096 walks
advance in lockstep: peek4 hashes all four extensions of every walk in one
vectorized call, a membership oracle (count-min sketch here; Bloom filter in
the wild) scores them, and roll_select commits the best base per walk.
"""

import jax.numpy as jnp
import numpy as np

from nthash_tpu.models import sketch as cms
from nthash_tpu.ops import blind_scan
from nthash_tpu.ops.kmer_jnp import hash_kmers

K, WIDTH_LOG2, WALKS, STEPS = 11, 16, 4096, 20
rng = np.random.default_rng(7)

# Build a "genome" and fill a sketch with its k-mer set.
genome = rng.integers(0, 4, size=200_000, dtype=np.uint8)
res = hash_kmers(jnp.asarray(genome), K, 1)
sk = cms.update(
    cms.CountMinSketch.zeros(1, WIDTH_LOG2), res.hashes, res.valid, WIDTH_LOG2
)

# Start walks at random genome k-mers and extend greedily by sketch support.
starts = rng.integers(0, len(genome) - K - STEPS, size=WALKS)
windows = np.stack([genome[s : s + K] for s in starts])
state = blind_scan.init_state(jnp.asarray(windows))

on_genome = 0
for _ in range(STEPS):
    probes = blind_scan.peek4(state)                     # U64 [WALKS, 4, 1]
    counts = cms.query(sk, probes, WIDTH_LOG2)  # [WALKS, 4]
    choice = jnp.argmax(counts, axis=1).astype(jnp.int32)
    state = blind_scan.roll_select(state, choice)
    on_genome += int(jnp.sum(jnp.max(counts, axis=1) > 0))

print(f"{WALKS} walks x {STEPS} steps; sketch-supported extensions: "
      f"{on_genome}/{WALKS * STEPS}")
