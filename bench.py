#!/usr/bin/env python
"""Throughput benchmark on one NVIDIA GPU: k-mer hashes/s at k=32.

Mirrors the reference benchmark harness (reference examples/benchmark.cpp:
28-45: in-memory random reads, roll-all) at the BASELINE.json config:
1M x 150 bp reads, k=32. Baseline to beat: the reference measured 1.28e8
hashes/s at k=32 h=1 on one CPU core (BASELINE.md).

Every measured path is first gated bit for bit against the host oracle
(nthash_tpu.oracle) on a slice; a failed gate exits non-zero. Each
hand-written kernel is timed beside the plain XLA path it replaces
(``*_xla_*`` keys), and the XLA scatter ingestion is timed alone at every
sketch and filter width. Times are the best and median of ``REPEATS``
calls, each fenced with ``jax.block_until_ready`` on the whole result.

Prints the card's name and power limit, then ONE JSON line last.
Run: python bench.py   (needs a GPU; refuses any other backend)
"""

import json
import os
import sys
import time

import numpy as np

import chip_smoke as cs

BASELINE_H1 = 1.28e8  # reference k=32 h=1 hashes/s, 1 CPU thread (BASELINE.md)
BASELINE_H4 = 4.30e8  # reference k=32 h=4 hashes/s
BASELINE_SEED = 1.64e8  # reference SeedNtHash {10101,11011} h=3 hashes/s
SEEDS = ("10101", "11011")  # BASELINE.json spaced-seed config
SEED_H = 3
B, L, K = 1 << 20, 150, 32
GATE_READS = 1024
ROWS = 4
COUNT_WIDTHS = (14, 20, 27)
BLOOM_WIDTHS = (17, 20, 30)
LONG_READS, LONG_L = 16384, 10_000
SP_LEN = 1 << 27        # 134 Mbp synthetic chromosome
STREAM_READS = 10_000_000
REPEATS = 5


def fail(what):
    print(json.dumps({"metric": what, "value": 0, "unit": "hashes/s",
                      "vs_baseline": 0}))
    sys.exit(1)


def main():
    import jax
    import jax.numpy as jnp

    print(f"card {cs.card_line()}", flush=True)
    if jax.default_backend() != "gpu":
        print(f"bench.py needs a GPU; JAX backend is {jax.default_backend()!r}",
              file=sys.stderr)
        sys.exit(2)
    from nthash_tpu import backend, oracle
    from nthash_tpu.models import bloom
    from nthash_tpu.models import sketch as cms
    from nthash_tpu.ops import kmer_pallas as kp
    from nthash_tpu.ops.kmer_jnp import hash_kmers
    from nthash_tpu.ops.seed_jnp import hash_kmers_seeds
    from nthash_tpu.parallel import dp, sp
    from nthash_tpu.parallel.mesh import SEQ_AXIS, device_mesh

    backend.enable_compile_cache()
    out = {}

    def measure(fn, *args):
        jax.block_until_ready(fn(*args))
        ts = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        return min(ts), float(np.median(ts))

    def rate(key, items, fn, *args):
        best, med = measure(fn, *args)
        out[key] = items / best
        out[key + "_median"] = items / med
        return items / best

    rng = np.random.default_rng(0xBE9C)
    codes_np = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes = jnp.asarray(codes_np)
    W = L - K + 1
    g = GATE_READS
    exp_h, exp_v = cs.oracle_windows(codes_np[:g], K, ROWS)

    # ---- hashing: Triton kernel vs the XLA scan --------------------------
    outs = kp.hash_kmers_tm(kp.prepare_codes(codes[:g]), K, 2,
                            emit_fwd_rev=True)
    ok = all(np.array_equal(cs.to_u64(outs[i]).T[:g], exp_h[..., i])
             for i in range(2))
    f_exp = np.stack([oracle.hash_all_windows(c, K, 1)[0]
                      for c in codes_np[:8]])
    ok = ok and np.array_equal(cs.to_u64(outs[2]).T[:8], f_exp)
    if not ok:
        fail("PARITY_FAILURE")
    del outs
    for h in (1, 4):
        rate(f"h{h}_kmers_per_s", B * W, jax.jit(
            lambda c, h=h: kp.hash_kmers_tm(kp.prepare_codes(c), K, h)), codes)
        rate(f"h{h}_xla_kmers_per_s", B * W, jax.jit(
            lambda c, h=h: hash_kmers(c, K, h).hashes), codes)

    # ---- spaced seeds (XLA, direct per-window) --------------------------
    ws = L - len(SEEDS[0]) + 1
    f_seed = jax.jit(lambda c: hash_kmers_seeds(c, SEEDS, SEED_H).hashes)
    sgot = f_seed(codes[:64]).to_np()
    for b in range(64):
        if not np.array_equal(
                sgot[b], oracle.hash_all_windows_seeds(codes_np[b], SEEDS,
                                                       SEED_H)[2]):
            fail("SEED_PARITY_FAILURE")
    rate("seed_kmers_per_s", B * ws, f_seed, codes)

    # ---- count: kernel buckets -> scatter-add, vs XLA scan -> scatter ----
    gate = jnp.asarray(cs.pad_batch(codes_np[:g], B))
    for wl in COUNT_WIDTHS:
        f = jax.jit(lambda c, wl=wl: cms.scatter_counts(jnp.stack([
            b.reshape(-1) for b in backend.bucket_rows(c, K, ROWS, wl)]), wl))
        if not cs.sketch_matches(f(gate), cs.oracle_buckets(exp_h, exp_v, wl),
                                 int(exp_v.sum())):
            fail(f"COUNT_PARITY_FAILURE_W{wl}")
        rate(f"count_w{wl}_kmers_per_s", B * W, f, codes)
        if wl == 20:
            def xla_count(c):
                r = hash_kmers(c, K, ROWS)
                idx = (r.hashes.lo & jnp.uint32((1 << wl) - 1)).astype(
                    jnp.int32)
                idx = jnp.where(r.valid[..., None], idx, 1 << wl)
                return cms.scatter_counts(idx.reshape(-1, ROWS).T, wl)
            rate(f"count_w{wl}_xla_kmers_per_s", B * W, jax.jit(xla_count),
                 codes)
        idx = jax.random.randint(jax.random.PRNGKey(wl), (ROWS, B * W), 0,
                                 1 << wl, jnp.int32)
        rate(f"scatter_count_w{wl}_updates_per_s", ROWS * B * W,
             jax.jit(lambda i, wl=wl: cms.scatter_counts(i, wl)), idx)
        del idx

    # ---- Bloom: kernel buckets -> presence scatter -> packed words -------
    for wl in BLOOM_WIDTHS:
        zeros = bloom.BloomFilter.zeros(wl).words
        f = jax.jit(lambda c, w, wl=wl: bloom.insert_from_buckets(
            bloom.BloomFilter(w), backend.bucket_rows(c, K, ROWS, wl),
            emitted_width_log2=wl).words)
        if not cs.bloom_matches(f(gate, zeros),
                                *cs.oracle_bloom(exp_h, exp_v, wl)):
            fail(f"BLOOM_PARITY_FAILURE_W{wl}")
        rate(f"bloom_w{wl}_kmers_per_s", B * W, f, codes, zeros)
        idx = jax.random.randint(jax.random.PRNGKey(wl), (ROWS * B * W,), 0,
                                 1 << wl, jnp.int32)
        rate(f"scatter_bloom_w{wl}_updates_per_s", ROWS * B * W,
             jax.jit(lambda i, wl=wl: bloom.presence_words(i, wl)), idx)
        del idx, zeros
    del gate

    # ---- DP steps on all devices ----------------------------------------
    mesh = device_mesh()
    sharded = dp.shard_reads(codes, mesh)
    sk0 = cms.CountMinSketch.zeros(2, 14)
    hs, valid, _ = dp.hash_and_sketch(sharded, sk0, K, 2, 14, mesh,
                                      time_major=True)
    if not (all(np.array_equal(cs.to_u64(jax.tree_util.tree_map(
            lambda x: x[:, :g], hs[i])).T, exp_h[..., i]) for i in range(2))
            and np.array_equal(np.asarray(valid[:, :g]).T, exp_v)):
        fail("DP_PARITY_FAILURE")
    del hs, valid
    rate("dp_step_kmers_per_s", B * W, jax.jit(
        lambda c, s: dp.hash_and_sketch(c, s, K, 2, 14, mesh,
                                        time_major=True)), sharded, sk0)
    skf = cms.CountMinSketch.zeros(ROWS, 20)
    rate("dp_fused_kmers_per_s", B * W, jax.jit(
        lambda c, s: dp.fused_count(c, s, K, mesh)), sharded, skf)
    del sharded, codes

    # ---- long reads: kernel (time-chunked grid) vs the XLA scan ----------
    lr_np = rng.integers(0, 4, size=(LONG_READS, LONG_L), dtype=np.uint8)
    lr = jnp.asarray(lr_np)
    f_lr = jax.jit(lambda c: kp.hash_kmers_tm(kp.prepare_codes(c), K, 1))
    got = cs.to_u64(jax.tree_util.tree_map(lambda x: x[:, :4], f_lr(lr)[0]))
    if not np.array_equal(got.T, cs.oracle_windows(lr_np[:4], K, 1)[0][..., 0]):
        fail("LONG_READ_PARITY_FAILURE")
    wl_ = LONG_READS * (LONG_L - K + 1)
    rate("long_kmers_per_s", wl_, f_lr, lr)
    rate("long_xla_kmers_per_s", wl_,
         jax.jit(lambda c: hash_kmers(c, K, 1).hashes), lr)
    del lr, lr_np

    # ---- SP: one 134 Mbp sequence, k-mers and spaced seeds ---------------
    seq_mesh = device_mesh(axis=SEQ_AXIS)
    seq_np = rng.integers(0, 4, size=SP_LEN, dtype=np.uint8)
    seq = sp.shard_sequence(jnp.asarray(seq_np), seq_mesh, k=K)
    hs, valid = sp.hash_long_sequence(seq, K, 1, seq_mesh)
    tile = sp.pick_tile(seq.shape[0] // seq_mesh.devices.size, K)
    if not cs.sp_matches(seq_np, hs, valid, starts=(0, 5 * tile - 64)):
        fail("SP_PARITY_FAILURE")
    del hs, valid
    rate("sp_kmers_per_s", SP_LEN - K + 1,
         lambda s: sp.hash_long_sequence(s, K, 1, seq_mesh), seq)
    hs, valid = sp.hash_long_sequence_seeds(seq, SEEDS, 1, seq_mesh)
    if not cs.sp_matches(seq_np, hs, valid, seeds=SEEDS):
        fail("SP_SEED_PARITY_FAILURE")
    del hs, valid
    rate("sp_seed_kmers_per_s", SP_LEN - len(SEEDS[0]) + 1,
         lambda s: sp.hash_long_sequence_seeds(s, SEEDS, 1, seq_mesh), seq)
    del seq, seq_np

    # ---- scalar facade on the host (per-call Python cost) ----------------
    from nthash_tpu.api import NtHash

    fac_seq = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, size=1_000_000)].tobytes().decode()
    fh = NtHash(fac_seq, 1, K, engine="oracle")
    fh.roll()
    t0 = time.perf_counter()
    nrolls = sum(1 for _ in iter(fh.roll, False))
    out["facade_rolls_per_s"] = nrolls / (time.perf_counter() - t0)
    if nrolls + 1 != len(fac_seq) - K + 1:
        fail("FACADE_COUNT_FAILURE")

    # ---- streaming end to end: FASTQ -> parse -> H2D -> fused count ------
    from nthash_tpu.io import native_loader
    from nthash_tpu.io.stream import (
        stream_code_batches, stream_code_batches_parallel)
    from nthash_tpu.models.pipeline import PipelineConfig, ReadHashingPipeline
    import tempfile

    genome = cs.make_genome(rng, cs.GENOME_LEN)
    with tempfile.TemporaryDirectory(prefix="nthash_bench_") as tmp:
        path = os.path.join(tmp, "reads.fq")
        total, _ = cs.write_stream(path, rng, genome, STREAM_READS, 1)
        cfg = PipelineConfig(k=K, num_hashes=ROWS, sketch_width_log2=20)
        warm = ReadHashingPipeline(cfg)
        rl = cs.READ_LEN
        warm.count_file(path, batch_size=B, read_length=rl)  # compiles
        pipe = ReadHashingPipeline(cfg)
        t0 = time.perf_counter()
        n = pipe.count_file(path, batch_size=B, read_length=rl,
                            threads=cs.PARSE_THREADS)
        dt = time.perf_counter() - t0
        if n != STREAM_READS or not bool(jnp.all(
                jnp.sum(pipe.sketch.rows, axis=1) == total)):
            fail("STREAM_COUNT_FAILURE")
        out["stream_reads_per_s"] = STREAM_READS / dt

        def parse_rate(mk):
            t0 = time.perf_counter()
            assert sum(m for _, m in mk()) == STREAM_READS
            return STREAM_READS / (time.perf_counter() - t0)

        out["stream_parse_reads_per_s"] = parse_rate(
            lambda: stream_code_batches(path, B, rl))
        out["stream_parse_parallel_reads_per_s"] = parse_rate(
            lambda: stream_code_batches_parallel(path, B, rl,
                                                 threads=cs.PARSE_THREADS))
        out["stream_file_gb"] = os.path.getsize(path) / 1e9
    out["parser"] = str(native_loader.library_path())

    dev = jax.devices()[0]
    h1 = out["h1_kmers_per_s"]
    print(json.dumps({
        "metric": "kmer_hashes_per_s_per_chip_k32_h1",
        "value": h1,
        "unit": "hashes/s",
        "vs_baseline": h1 / BASELINE_H1,
        "h4_vs_baseline": 4 * out["h4_kmers_per_s"] / BASELINE_H4,
        "seed_vs_baseline": (len(SEEDS) * SEED_H * out["seed_kmers_per_s"]
                             / BASELINE_SEED),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": cs.card_line(),
        "k": K, "read_len": L, "reads": B, "repeats": REPEATS,
        "host_cpu_cores": os.cpu_count(),
        **out,
    }))


if __name__ == "__main__":
    main()
