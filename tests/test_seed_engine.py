"""jnp spaced-seed engine vs the host oracle: random-pattern fuzz."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from nthash_tpu import oracle
from nthash_tpu.constants import encode_ascii
from nthash_tpu.ops.seed_jnp import care_runs, hash_kmers_seeds, seed_taps


def check(codes, seeds, h):
    res = hash_kmers_seeds(jnp.asarray(codes), seeds, h)
    got = res.hashes.to_np()
    gf, gr = res.fwd.to_np(), res.rev.to_np()
    if codes.ndim == 1:
        codes, got, gf, gr = codes[None], got[None], gf[None], gr[None]
    for b in range(codes.shape[0]):
        fwd, rev, hashes = oracle.hash_all_windows_seeds(codes[b], seeds, h)
        assert np.array_equal(got[b], hashes)
        assert np.array_equal(gf[b], fwd)
        assert np.array_equal(gr[b], rev)


def _random_seed(rng, k):
    while True:
        s = "".join(rng.choice(["0", "1"], size=k))
        if "1" in s:
            return s


@pytest.mark.parametrize("k", [1, 2, 5, 13, 32, 64, 65])
def test_fuzz_random_patterns(rng, k):
    seeds = tuple(_random_seed(rng, k) for _ in range(2))
    codes = rng.integers(0, 5, size=(3, 80), dtype=np.uint8)
    check(codes, seeds, 2)


def test_all_care_equals_kmer(rng):
    from nthash_tpu.ops.kmer_jnp import hash_kmers

    codes = rng.integers(0, 5, size=(4, 40), dtype=np.uint8)
    k = 11
    a = hash_kmers_seeds(jnp.asarray(codes), ("1" * k,), 3).hashes.to_np()
    b = hash_kmers(jnp.asarray(codes), k, 3).hashes.to_np()
    assert np.array_equal(a, b)


def test_single_care_position(rng):
    codes = rng.integers(0, 4, size=(2, 20), dtype=np.uint8)
    check(codes, ("00100",), 2)


def test_rna_and_case_for_seeds():
    a = encode_ascii("ACGTACACTGGACTGAGTCT")
    b = encode_ascii("acguacacuggacugagucu")
    seeds = ("110011011",)
    ha = hash_kmers_seeds(jnp.asarray(a), seeds, 2).hashes.to_np()
    hb = hash_kmers_seeds(jnp.asarray(b), seeds, 2).hashes.to_np()
    assert np.array_equal(ha, hb)


def test_palindromic_seed_strand_neutral(rng):
    # palindromic pattern => canonical hash equal on reverse complement
    seeds = ("1011101",)
    k = 7
    codes = rng.integers(0, 4, size=(20,), dtype=np.uint8)
    rc = np.array([3 - c for c in codes[::-1]], dtype=np.uint8)
    hf = hash_kmers_seeds(jnp.asarray(codes), seeds, 1).hashes.to_np()
    hr = hash_kmers_seeds(jnp.asarray(rc), seeds, 1).hashes.to_np()
    assert np.array_equal(hf, hr[::-1])


def test_care_runs():
    assert care_runs("11100111") == [(0, 3), (5, 8)]
    assert care_runs("10101") == [(0, 1), (2, 3), (4, 5)]
    assert care_runs("11111") == [(0, 5)]
    assert care_runs("0110") == [(1, 3)]
    with pytest.raises(ValueError):
        care_runs("000")


def test_seed_taps_offsets():
    taps = seed_taps("110011")
    assert [(t.off_in, t.off_out) for t in taps] == [(4, 6), (0, 2)]
