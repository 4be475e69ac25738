"""Triton k-mer kernel: the kernel body in the Pallas interpreter against the
host oracle, its wrapper's shapes and padding, and its CUDA lowering.

The compiled kernel runs only on a GPU: ``gpu``-marked tests here and the
phases of chip_smoke.py run it there.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from nthash_tpu import oracle
from nthash_tpu.constants import encode_ascii
from nthash_tpu.ops import kmer_pallas as kp

from test_golden_extended import K65H3, SEQ

# (name, k, num_hashes, reads, length, mode, with_n)
#   mode: "hashes" | "fwd_rev" | a bucket width_log2. With this few reads
#   the kernel splits windows into time chunks of max(8 (k - 1), ...):
#   32 windows at k=5, 248 at k=32, so the longer cases cross chunks.
CASES = [
    ("k5_h1", 5, 1, 8, 24, "hashes", False),
    ("k5_h4_nruns", 5, 4, 8, 24, "hashes", True),
    ("k32_h1_odd_reads", 32, 1, 3, 40, "hashes", True),
    ("k32_h4", 32, 4, 5, 40, "hashes", False),
    ("k7_fwd_rev", 7, 1, 6, 20, "fwd_rev", True),
    ("k5_fwd_rev_chunked", 5, 1, 2, 70, "fwd_rev", True),
    ("k5_buckets_w10", 5, 4, 9, 24, 10, True),
    ("k32_buckets_w20", 32, 2, 4, 40, 20, True),
    ("k5_buckets_chunked", 5, 4, 2, 90, 10, True),
    ("k5_long_chunked", 5, 2, 2, 320, "hashes", True),
    ("k32_long_chunked", 32, 1, 1, 400, "hashes", True),
    ("k1_h2", 1, 2, 4, 12, "hashes", True),
]


def _codes(rng, reads, length, with_n):
    codes = rng.integers(0, 4, size=(reads, length), dtype=np.uint8)
    if with_n:
        for r in range(reads):
            a = rng.integers(0, length)
            codes[r, a:a + rng.integers(1, 4)] = 4
        codes[0, -1] = 7  # any code above 4 is invalid too
    return codes


@pytest.mark.parametrize(
    "name,k,h,reads,length,mode,with_n", CASES, ids=[c[0] for c in CASES])
def test_kernel_interpret_matches_oracle(rng, name, k, h, reads, length,
                                         mode, with_n):
    codes = _codes(rng, reads, length, with_n)
    tm = kp.prepare_codes(jnp.asarray(codes))
    kw = dict(interpret=True)
    exp = [oracle.hash_all_windows(c, k, h) for c in codes]
    if mode == "hashes":
        got = kp.hash_kmers_tm(tm, k, h, **kw)
        for i in range(h):
            want = np.stack([e[2][:, i] for e in exp])
            valid = np.stack([e[3] for e in exp])
            assert np.array_equal(got[i].to_np().T[:reads][valid],
                                  want[valid])
    elif mode == "fwd_rev":
        got = kp.hash_kmers_tm(tm, k, h, emit_fwd_rev=True, **kw)
        assert len(got) == h + 2
        assert np.array_equal(got[h].to_np().T[:reads],
                              np.stack([e[0] for e in exp]))
        assert np.array_equal(got[h + 1].to_np().T[:reads],
                              np.stack([e[1] for e in exp]))
    else:
        got = kp.hash_kmers_tm(tm, k, h, emit_buckets=mode, **kw)
        valid = np.stack([e[3] for e in exp])
        for i in range(h):
            want = np.where(
                valid,
                np.stack([e[2][:, i] for e in exp]) & np.uint64((1 << mode) - 1),
                1 << mode)
            b = np.asarray(got[i])
            assert b.dtype == np.int32
            assert np.array_equal(b.T[:reads], want.astype(np.int32))
            # padded reads carry only the sentinel
            assert np.all(b[:, reads:] == 1 << mode)


def test_kernel_interpret_k65_golden():
    """k = 65 (past the 64-bit rotate period) against the reference's own
    K65H3 goldens."""
    codes = np.tile(encode_ascii(SEQ), (2, 1))
    got = kp.hash_kmers_tm(kp.prepare_codes(jnp.asarray(codes)), 65, 3,
                           emit_fwd_rev=True, interpret=True)
    for pos, h0, h1, h2, fwd in K65H3:
        for r in range(2):
            assert [int(got[i].to_np()[pos, r]) for i in (0, 1, 2, 3)] == [
                h0, h1, h2, fwd]


def test_kernel_golden():
    """README golden vector through the kernel path."""
    seq = "TGACTGATCGAGTCGTACTAG"
    codes = np.tile(encode_ascii(seq), (4, 1))
    res = kp.hash_kmers_tm(kp.prepare_codes(jnp.asarray(codes)), 5, 1,
                           interpret=True)
    h = res[0].to_np()
    assert h[0, 0] == 0x606F60C2A6FD7D2D
    assert h[16, 3] == 0x80D9E6D93C77AD71


def test_pad_reads():
    assert kp.BLOCK_R == 256
    assert kp.pad_reads(1) == 256
    assert kp.pad_reads(256) == 256
    assert kp.pad_reads(257) == 512
    assert kp.pad_reads(5000) == 5120


def test_padding_reads_are_invalid(rng):
    # padded (phantom) reads must not produce valid windows
    B, L = 3, 30
    codes = rng.integers(0, 6, size=(B, L), dtype=np.uint8)
    tm = np.asarray(kp.prepare_codes(jnp.asarray(codes)))
    assert tm.shape == (L, kp.BLOCK_R) and tm.dtype == np.uint8
    assert np.all(tm[:, B:] == 4)
    assert np.array_equal(tm[:, :B], np.minimum(codes, 4).T)


@pytest.mark.parametrize("windows,k,reads,expect", [
    (119, 32, 1 << 20, 119),        # enough read blocks: one chunk
    (9969, 32, 16384, 624),         # few long reads: split in time
    (9969, 32, 1, 10),              # one block: TARGET_PROGRAMS chunks
    (300, 32, 256, 248),            # floor of 8 (k - 1) windows
])
def test_pick_time_chunk(windows, k, reads, expect):
    got = kp.pick_time_chunk(windows, k, reads)
    assert got == min(windows, max(expect, 8 * (k - 1)))
    assert 1 <= got <= windows


def test_kernel_rejects_bad_shapes():
    tm = jnp.zeros((20, 256), jnp.uint8)
    with pytest.raises(ValueError, match="smaller than k"):
        kp.hash_kmers_tm(tm, 21, interpret=True)
    with pytest.raises(ValueError, match="multiple of"):
        kp.hash_kmers_tm(tm[:, :100], 5, interpret=True)
    with pytest.raises(ValueError, match="exclusive"):
        kp.hash_kmers_tm(tm, 5, emit_fwd_rev=True, emit_buckets=10,
                         interpret=True)


def test_compiled_kernel_refuses_cpu():
    """No fallback to the interpreter: the compiled kernel needs a GPU."""
    with pytest.raises(RuntimeError, match="GPU only"):
        kp.hash_kmers_tm(jnp.zeros((20, 256), jnp.uint8), 5)


@pytest.mark.parametrize("kw", [
    dict(num_hashes=1),
    dict(num_hashes=4),
    dict(num_hashes=4, emit_buckets=27),
    dict(num_hashes=1, emit_fwd_rev=True),
], ids=["h1", "h4", "buckets", "fwd_rev"])
def test_kernel_lowers_for_cuda(monkeypatch, kw):
    """The kernel lowers to a Triton module for CUDA: every primitive in
    its body has a Triton lowering and every load/store is a power of two
    (compiling that module needs the card; chip_smoke.py does it)."""
    import jax

    from nthash_tpu import backend

    monkeypatch.setattr(backend, "require_gpu", lambda what: None)
    f = jax.jit(lambda c: kp.hash_kmers_tm(c, 32, **kw))
    text = f.trace(jax.ShapeDtypeStruct((150, 1024), jnp.uint8)).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "kmer_roll" in text


@pytest.mark.gpu
def test_kernel_compiled_matches_jnp(gpu, rng):
    """The compiled kernel on the card against the XLA engine."""
    from nthash_tpu.ops.kmer_jnp import hash_kmers

    codes = rng.integers(0, 5, size=(1000, 150), dtype=np.uint8)
    got = kp.hash_kmers_tm(kp.prepare_codes(jnp.asarray(codes)), 32, 4)
    ref = hash_kmers(jnp.asarray(codes), 32, 4)
    valid = np.asarray(ref.valid)
    for i in range(4):
        assert np.array_equal(got[i].to_np().T[:1000][valid],
                              ref.hashes.to_np()[..., i][valid])
