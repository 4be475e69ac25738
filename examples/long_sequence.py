#!/usr/bin/env python
"""Genome-scale sequences and long reads.

Two capabilities the sequential reference handles by just looping
(reference src/kmer.cpp:246-264) and this framework handles by
restructuring:

- one chromosome-length sequence sharded over the device mesh with a
  (k-1)-base halo exchange, hashed as overlapping pseudo-reads
  (parallel/sp.py), and
- nanopore-length reads through the batched engine that
  nthash_tpu.backend picks (the Triton kernel on a GPU, whose grid splits
  long reads into time chunks; the XLA scan elsewhere).

Run: python examples/long_sequence.py [length]
"""

import sys

import numpy as np
import jax.numpy as jnp

from nthash_tpu.parallel import sp
from nthash_tpu.parallel.mesh import SEQ_AXIS, device_mesh

K = 32


def main():
    length = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 20
    rng = np.random.default_rng(0)
    seq = rng.integers(0, 4, size=(length,), dtype=np.uint8)

    mesh = device_mesh(axis=SEQ_AXIS)
    n = mesh.devices.size
    length -= length % n  # shard evenly
    sharded = sp.shard_sequence(jnp.asarray(seq[:length]), mesh)

    hashes, valid = sp.hash_long_sequence(sharded, K, 2, mesh)
    nvalid = int(np.asarray(valid).sum())
    h0 = hashes[0]  # first nte64 hash, one flat [L] array per hash
    print(
        f"hashed {length:,} bases over {n} device(s): "
        f"{nvalid:,} valid {K}-mers"
    )
    print(f"window 0 hash: {int(h0.to_np()[0]):#018x}")

    # long-read batch through the backend's hash engine
    from nthash_tpu import backend

    reads = rng.integers(0, 4, size=(4, 10_000), dtype=np.uint8)
    res, rvalid = backend.hash_windows_tm(jnp.asarray(reads), K, 2)
    print(
        f"long reads: {reads.shape[0]} x {reads.shape[1]:,} bp -> "
        f"{int(np.asarray(rvalid).sum()):,} windows, "
        f"first hash {int(res[0].to_np()[0, 0]):#018x}"
    )


if __name__ == "__main__":
    main()
