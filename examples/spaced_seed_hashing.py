#!/usr/bin/env python
"""Spaced-seed hashing, two ways.

(The reference ships an empty placeholder here —
examples/spaced_seed_hashing.cpp is 0 bytes. This is the real thing.)

1. The scalar facade: SeedNtHash walks a sequence under two patterns.
2. The batched device engine: the same hashes for every window of a whole
   read batch in one call (the batched way).
"""

import numpy as np

from nthash_tpu import SeedNtHash
from nthash_tpu.constants import encode_ascii

SEQ = "TGACTGATCGAGTCGTACTAG"
SEEDS = ("10101", "11011")

print("== scalar facade ==")
nth = SeedNtHash(SEQ, SEEDS, 3, 5)
while nth.roll():
    p = nth.get_pos()
    print(p, SEQ[p : p + 5], *(hex(h) for h in nth.hashes()[:2]), "...")

print("\n== batched device engine ==")
import jax.numpy as jnp

from nthash_tpu.ops.seed_jnp import hash_kmers_seeds

batch = np.stack([encode_ascii(SEQ), encode_ascii(SEQ[::-1])])
res = hash_kmers_seeds(jnp.asarray(batch), SEEDS, 3)
print("hashes shape [B, W, S*H]:", res.hashes.to_np().shape)
print("read 0, window 0:", [hex(int(h)) for h in res.hashes.to_np()[0, 0][:3]])
