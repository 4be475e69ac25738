"""chip_smoke.py's data generator and gates at tiny sizes (the phases
themselves need a GPU and run there)."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

import chip_smoke as cs
from nthash_tpu import oracle


@pytest.fixture
def genome():
    return cs.make_genome(np.random.default_rng(3), 5000)


def test_genome_alphabet(genome):
    assert genome.dtype == np.uint8 and genome.shape == (5000,)
    assert set(np.unique(genome)) == {0, 1, 2, 3}


def test_reads_come_from_both_strands(genome):
    reads = cs.sample_reads(np.random.default_rng(4), genome, 400, 60,
                            sub_rate=0.0, n_read_frac=0.0)
    text = genome.tobytes()
    rc = (3 - genome[::-1]).tobytes()
    fwd = sum(r.tobytes() in text for r in reads)
    rev = sum(r.tobytes() in rc for r in reads)
    assert fwd + rev == 400 and fwd > 100 and rev > 100


def test_substitution_and_n_rates(genome):
    clean = cs.sample_reads(np.random.default_rng(6), genome, 20000, 150,
                            sub_rate=0.0, n_read_frac=0.0)
    noisy = cs.sample_reads(np.random.default_rng(6), genome, 20000, 150)
    with_n = (noisy == 4).any(axis=1)
    assert 0.002 < with_n.mean() < 0.009
    diff = (noisy != clean) & (noisy != 4)
    assert 0.008 < diff.mean() < 0.012
    runs = (noisy[with_n] == 4).sum(axis=1)
    assert runs.min() >= 1 and runs.max() <= 10


def test_valid_windows_matches_oracle(genome):
    reads = cs.sample_reads(np.random.default_rng(7), genome, 300, 50,
                            n_read_frac=0.3)
    want = sum(int(oracle.window_valid(r, 11).sum()) for r in reads)
    assert cs.valid_windows(reads, 11) == want


def test_fastq_roundtrip_through_parser(genome, tmp_path):
    from nthash_tpu.io.stream import stream_code_batches

    reads = cs.sample_reads(np.random.default_rng(8), genome, 100, 40,
                            n_read_frac=0.2)
    path = tmp_path / "r.fq"
    cs.fastq_bytes(reads).tofile(str(path))
    got = np.concatenate([b[:n] for b, n in stream_code_batches(path, 64, 40)])
    assert np.array_equal(got, reads)


def test_write_stream_counts_and_keeps_head(genome, tmp_path, monkeypatch):
    monkeypatch.setattr(cs, "GEN_BLOCK", 64)
    monkeypatch.setattr(cs, "READ_LEN", 40)
    path = tmp_path / "s.fq"
    total, head = cs.write_stream(path, np.random.default_rng(9), genome,
                                  200, 10)
    assert head.shape == (10, 40)
    assert path.stat().st_size == 200 * (2 * 40 + 7)
    from nthash_tpu.io.stream import stream_code_batches

    allc = np.concatenate([b[:n] for b, n in stream_code_batches(path, 64, 40)])
    assert np.array_equal(allc[:10], head)
    assert total == cs.valid_windows(allc, cs.K)


def test_sketch_gate_exact_and_detects_corruption(genome):
    from nthash_tpu.models import sketch as cms
    from nthash_tpu.ops.kmer_jnp import hash_kmers

    reads = cs.sample_reads(np.random.default_rng(10), genome, 20, 40)
    hashes, valid = cs.oracle_windows(reads, 9, 2)
    res = hash_kmers(jnp.asarray(reads), 9, 2)
    sk = cms.update(cms.CountMinSketch.zeros(2, 12), res.hashes, res.valid, 12)
    sparse = cs.oracle_buckets(hashes, valid, 12)
    total = int(valid.sum())
    assert cs.sketch_matches(sk.rows, sparse, total)
    moved = sk.rows.at[0, int(sparse[0][0][0])].add(-1).at[0, 0].add(1)
    assert not cs.sketch_matches(moved, sparse, total)
    assert not cs.sketch_matches(sk.rows.at[1, 5].add(1), sparse, total)


def test_bloom_gate_exact_and_detects_corruption(genome):
    from nthash_tpu.models import bloom
    from nthash_tpu.ops.kmer_jnp import hash_kmers

    reads = cs.sample_reads(np.random.default_rng(11), genome, 20, 40)
    hashes, valid = cs.oracle_windows(reads, 9, 3)
    res = hash_kmers(jnp.asarray(reads), 9, 3)
    bf = bloom.insert(bloom.BloomFilter.zeros(16), res.hashes, res.valid, 16)
    pos, val, pc = cs.oracle_bloom(hashes, valid, 16)
    assert cs.bloom_matches(bf.words, pos, val, pc)
    extra = bf.words.at[int(np.setdiff1d(np.arange(2048), pos)[0])].set(1)
    assert not cs.bloom_matches(extra, pos, val, pc)


def test_pad_batch_adds_no_valid_window(genome):
    reads = cs.sample_reads(np.random.default_rng(12), genome, 5, 40)
    padded = cs.pad_batch(reads, 16)
    assert padded.shape == (16, 40)
    assert cs.valid_windows(padded, 9) == cs.valid_windows(reads, 9)


def test_refuses_cpu_before_any_phase(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and "stream" not in out
