#!/usr/bin/env python
"""Smoke test of the streaming hash -> count path on one NVIDIA GPU.

Drives the system's main path once, through the entry points a user calls,
at the size of BASELINE.json configuration 5: 10M reads of 150 bp sampled
from an E. coli-sized genome, streamed from FASTQ into a 2^27-wide count
sketch. Every phase is compared bit for bit with the host oracle
(nthash_tpu.oracle); the program is integer throughout, so every
comparison is exact.

Phases: card, data, stream (``ReadHashingPipeline.count_file``), step
(``ReadHashingPipeline.step``), bloom (``bloom.insert_from_buckets`` at
2^30 bits), long (16,384 reads x 10 kbp), sp (``sp.hash_long_sequence``
and ``sp.hash_long_sequence_seeds`` over the genome), cli (the ``hash``
command in-process). Each prints one line; a failed phase exits non-zero.
The last line is one JSON object naming the device.

``--cards 4`` runs only the multi-device paths (DP fused count over a
2M-read part of the stream, SP over the genome) on four GPUs of one host,
each compared with its one-card result in the same process.

Run: python chip_smoke.py [--seed N] [--cards 1|4]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

GENOME_LEN = 4_641_652     # E. coli K-12 MG1655
READS = 10_000_000
READ_LEN = 150
SUB_RATE = 0.01            # substitutions per base
N_READ_FRAC = 0.005        # reads that carry one N run
K = 32
NUM_HASHES = 4
STREAM_WIDTH_LOG2 = 27     # 4 rows x 2^27 int32 = 2 GB on the device
STEP_WIDTH_LOG2 = 20
BLOOM_WIDTH_LOG2 = 30      # 128 MB of packed words
BATCH = 1 << 20
PARSE_THREADS = 4           # byte-range shards parsed in parallel
GATE_READS = 4096
STEP_GATE_READS = 1024
LONG_READS, LONG_LEN = 16_384, 10_000
SEEDS = ("10101", "11011")
MULTI_READS = 2_000_000
GEN_BLOCK = 1 << 20
CLI_GOLDEN = "TGACT 606f60c2a6fd7d2d"

_ASCII = np.frombuffer(b"ACGTN", np.uint8)


# ---- data --------------------------------------------------------------

def make_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    """Uniform random ACGT codes (0-3), uint8 [length]."""
    return rng.integers(0, 4, size=length, dtype=np.uint8)


def sample_reads(rng: np.random.Generator, genome: np.ndarray, n: int,
                 read_len: int, sub_rate: float = SUB_RATE,
                 n_read_frac: float = N_READ_FRAC) -> np.ndarray:
    """[n, read_len] uint8 codes sampled from both strands of ``genome``,
    with substitutions at ``sub_rate`` per base and one N run (1-10 bases)
    in a ``n_read_frac`` share of the reads."""
    starts = rng.integers(0, len(genome) - read_len + 1, size=n)
    reads = genome[starts[:, None] + np.arange(read_len)]
    rc = rng.random(n) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    flat = reads.reshape(-1)
    pos = rng.integers(0, flat.size, size=rng.binomial(flat.size, sub_rate))
    flat[pos] = (flat[pos] + rng.integers(1, 4, size=pos.size,
                                          dtype=np.uint8)) % 4
    with_n = np.flatnonzero(rng.random(n) < n_read_frac)
    run = rng.integers(1, 11, size=with_n.size)
    at = rng.integers(0, read_len - run + 1)
    for r, a, m in zip(with_n, at, run):
        reads[r, a:a + m] = 4
    return reads


def valid_windows(codes: np.ndarray, k: int) -> int:
    """Exact number of windows free of N over a [n, L] code batch."""
    bad = np.flatnonzero((codes == 4).any(axis=1))
    w = codes.shape[1] - k + 1
    total = (codes.shape[0] - bad.size) * w
    if bad.size:
        p = np.pad(np.cumsum(codes[bad] == 4, axis=1), ((0, 0), (1, 0)))
        total += int(((p[:, k:] - p[:, :-k]) == 0).sum())
    return int(total)


def fastq_bytes(codes: np.ndarray) -> np.ndarray:
    """[n, L] codes -> FASTQ records as one [n, 2L + 7] uint8 array."""
    n, length = codes.shape
    rec = np.empty((n, 2 * length + 7), np.uint8)
    rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
    rec[:, 3:3 + length] = _ASCII[codes]
    rec[:, 3 + length:6 + length] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 6 + length:6 + 2 * length] = ord("I")
    rec[:, -1] = ord("\n")
    return rec


def write_stream(path: Path, rng: np.random.Generator, genome: np.ndarray,
                 n_reads: int, keep: int) -> tuple[int, np.ndarray]:
    """Write ``n_reads`` sampled reads to FASTQ in blocks. Returns (exact
    valid-window count, codes of the first ``keep`` reads)."""
    total, kept = 0, None
    with open(path, "wb") as fh:
        for lo in range(0, n_reads, GEN_BLOCK):
            block = sample_reads(rng, genome, min(GEN_BLOCK, n_reads - lo),
                                 READ_LEN)
            if kept is None:
                kept = block[:keep].copy()
            total += valid_windows(block, K)
            fastq_bytes(block).tofile(fh)
    return total, kept


# ---- gates -------------------------------------------------------------

def to_u64(u) -> np.ndarray:
    return (np.asarray(u.hi).astype(np.uint64) << np.uint64(32)
            | np.asarray(u.lo).astype(np.uint64))


def oracle_windows(codes: np.ndarray, k: int, num_hashes: int):
    """Host oracle over a [n, L] batch: (hashes [n, W, H], valid [n, W])."""
    from nthash_tpu import oracle

    out = [oracle.hash_all_windows(row, k, num_hashes) for row in codes]
    return (np.stack([o[2] for o in out]), np.stack([o[3] for o in out]))


def oracle_buckets(hashes: np.ndarray, valid: np.ndarray,
                   width_log2: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per row: (oracle-nonzero bucket positions, their counts)."""
    mask = np.uint64((1 << width_log2) - 1)
    return [
        np.unique((hashes[..., r][valid] & mask).astype(np.int64),
                  return_counts=True)
        for r in range(hashes.shape[-1])
    ]


def sketch_matches(rows, sparse, total: int) -> bool:
    """Device sketch == oracle histogram: exact counts at every
    oracle-nonzero bucket and the row total equal to the update count.
    With nonnegative counts the two force every other bucket to zero."""
    import jax.numpy as jnp

    for r, (pos, cnt) in enumerate(sparse):
        got = np.asarray(jnp.take(rows[r], jnp.asarray(pos), axis=0))
        if not (np.array_equal(got, cnt.astype(np.int32))
                and int(jnp.sum(rows[r])) == total == int(cnt.sum())):
            return False
    return True


def oracle_bloom(hashes: np.ndarray, valid: np.ndarray, width_log2: int):
    """(set word positions, their values, total popcount) of the packed
    filter holding every valid window's every hash."""
    from nthash_tpu.models.bloom import bit_index, word_index

    idx = (hashes[valid] & np.uint64((1 << width_log2) - 1)).astype(np.int64)
    idx = np.unique(idx.reshape(-1))
    words = word_index(idx)
    pos, inv = np.unique(words, return_inverse=True)
    val = np.zeros(pos.size, np.uint32)
    np.bitwise_or.at(val, inv, np.uint32(1) << bit_index(idx).astype(np.uint32))
    return pos, val, int(idx.size)


def bloom_matches(words, pos, val, popcount: int) -> bool:
    import jax
    import jax.numpy as jnp

    got = np.asarray(jnp.take(words, jnp.asarray(pos), axis=0))
    pc = int(jnp.sum(jax.lax.population_count(words).astype(jnp.int32)))
    return np.array_equal(got, val) and pc == popcount


# ---- running -----------------------------------------------------------

class PhaseFailed(RuntimeError):
    pass


def report(name: str, seconds: float, rate: float, unit: str,
           compared: str, ok: bool) -> None:
    print(f"{name:7s} {seconds:10.4f} s  {rate:.6g} {unit}  vs {compared}: "
          f"{'exact' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise PhaseFailed(name)


def best_time(fn, *args, repeats: int = 3) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def pad_batch(codes: np.ndarray, n: int) -> np.ndarray:
    """Pad a read slice with all-N reads to ``n`` rows (same compiled
    shape as a full batch; the padding adds no valid window)."""
    out = np.full((n, codes.shape[1]), 4, np.uint8)
    out[: codes.shape[0]] = codes
    return out


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def count_stream(cfg, path: Path, n_reads: int, expect_total: int,
                 slice_path: Path, sparse, slice_total: int):
    """Stream ``path`` and a gate slice through ``count_file``; returns
    (seconds for the stream, ok, sketch rows)."""
    import jax.numpy as jnp

    from nthash_tpu.models.pipeline import ReadHashingPipeline

    gate = ReadHashingPipeline(cfg)  # fresh sketch; compiles the step
    gate.count_file(slice_path, batch_size=BATCH, read_length=READ_LEN)
    ok = sketch_matches(gate.sketch.rows, sparse, slice_total)
    del gate
    pipe = ReadHashingPipeline(cfg)
    t0 = time.perf_counter()
    got = pipe.count_file(path, batch_size=BATCH, read_length=READ_LEN,
                          threads=PARSE_THREADS)
    seconds = time.perf_counter() - t0
    totals = np.asarray(jnp.sum(pipe.sketch.rows, axis=1))
    ok = ok and got == n_reads and bool(np.all(totals == expect_total))
    return seconds, ok, pipe.sketch.rows


def phase_stream(tmp: Path, rng, genome):
    from nthash_tpu.io import native_loader
    from nthash_tpu.models.pipeline import PipelineConfig

    t0 = time.perf_counter()
    path = tmp / "reads.fq"
    total, head = write_stream(path, rng, genome, READS, BATCH)
    slice_path = tmp / "slice.fq"
    fastq_bytes(head[:GATE_READS]).tofile(str(slice_path))
    gh, gv = oracle_windows(head[:GATE_READS], K, NUM_HASHES)
    print(f"data    {time.perf_counter() - t0:10.4f} s  genome {GENOME_LEN} "
          f"bp, {READS} reads x {READ_LEN} bp, "
          f"{path.stat().st_size / 1e9:.3f} GB FASTQ, {total} valid "
          f"{K}-mers", flush=True)
    lib = native_loader.library_path()
    print(f"parser  {lib if lib else 'numpy (native parser unavailable)'}",
          flush=True)
    if lib is None:
        raise PhaseFailed("stream: the native parser did not build")
    if total >= 1 << 31:
        raise PhaseFailed("stream: row totals would overflow int32")
    cfg = PipelineConfig(k=K, num_hashes=NUM_HASHES,
                         sketch_width_log2=STREAM_WIDTH_LOG2, n_devices=1)
    seconds, ok, _ = count_stream(
        cfg, path, READS, total, slice_path,
        oracle_buckets(gh, gv, STREAM_WIDTH_LOG2), int(gv.sum()))
    report("stream", seconds, READS / seconds, "reads/s",
           f"host valid-window count per row ({total}) and the oracle "
           f"histogram of a {GATE_READS}-read slice at width "
           f"2^{STREAM_WIDTH_LOG2}", ok)
    path.unlink()
    return head, gh, gv


def phase_step(head, gh, gv):
    import jax
    import jax.numpy as jnp

    from nthash_tpu.models.pipeline import PipelineConfig, ReadHashingPipeline

    cfg = PipelineConfig(k=K, num_hashes=NUM_HASHES,
                         sketch_width_log2=STEP_WIDTH_LOG2, n_devices=1)
    pipe = ReadHashingPipeline(cfg)
    g = STEP_GATE_READS
    hashes, valid = pipe.step(head)
    ok = all(np.array_equal(to_u64(jax.tree_util.tree_map(
        lambda x: x[:, :g], h)).T, gh[:g, :, i])
        for i, h in enumerate(hashes))
    ok = ok and np.array_equal(np.asarray(valid[:, :g]).T, gv[:g])
    ok = ok and bool(np.all(np.asarray(jnp.sum(pipe.sketch.rows, axis=1))
                            == valid_windows(head, K)))
    del hashes, valid
    gate = ReadHashingPipeline(cfg)
    gate.step(pad_batch(head[:g], head.shape[0]))
    ok = ok and sketch_matches(
        gate.sketch.rows, oracle_buckets(gh[:g], gv[:g], STEP_WIDTH_LOG2),
        int(gv[:g].sum()))
    del gate
    seconds = best_time(pipe.step, jnp.asarray(head))
    w = head.shape[0] * (READ_LEN - K + 1)
    report("step", seconds, w / seconds, "k-mers/s",
           f"oracle hashes, validity and sketch of a {g}-read "
           f"slice; batch row totals", ok)


def phase_bloom(head, gh, gv):
    import jax
    import jax.numpy as jnp

    from nthash_tpu import backend
    from nthash_tpu.models import bloom

    @jax.jit
    def insert(codes, words):
        bucks = backend.bucket_rows(codes, K, NUM_HASHES, BLOOM_WIDTH_LOG2)
        return bloom.insert_from_buckets(
            bloom.BloomFilter(words), bucks,
            emitted_width_log2=BLOOM_WIDTH_LOG2).words

    g = STEP_GATE_READS
    zeros = bloom.BloomFilter.zeros(BLOOM_WIDTH_LOG2).words
    words = insert(jnp.asarray(pad_batch(head[:g], head.shape[0])), zeros)
    ok = bloom_matches(words, *oracle_bloom(gh[:g], gv[:g], BLOOM_WIDTH_LOG2))
    del words
    codes = jnp.asarray(head)
    seconds = best_time(insert, codes, zeros)
    w = head.shape[0] * (READ_LEN - K + 1)
    report("bloom", seconds, w / seconds, "k-mers/s",
           f"oracle words at every set position and total popcount of a "
           f"{g}-read slice, 2^{BLOOM_WIDTH_LOG2}-bit filter", ok)


def phase_long(rng, genome):
    import jax
    import jax.numpy as jnp

    from nthash_tpu import backend

    reads = sample_reads(rng, genome, LONG_READS, LONG_LEN)
    f = jax.jit(lambda c: backend.hash_windows_tm(c, K, 1))
    res, valid = f(jnp.asarray(reads))
    got = to_u64(jax.tree_util.tree_map(lambda x: x[:, :4], res[0])).T
    v = np.asarray(valid[:, :4]).T
    eh, ev = oracle_windows(reads[:4], K, 1)
    ok = np.array_equal(got, eh[..., 0]) and np.array_equal(v, ev)
    del res, valid
    seconds = best_time(f, jnp.asarray(reads))
    w = LONG_READS * (LONG_LEN - K + 1)
    report("long", seconds, w / seconds, "k-mers/s",
           "oracle hashes and validity of 4 reads", ok)


def sp_hashes(codes, mesh, seeds=None):
    from nthash_tpu.parallel import sp

    k = len(seeds[0]) if seeds else K
    dev = sp.shard_sequence(codes, mesh, k=k)
    if seeds:
        return sp.hash_long_sequence_seeds(dev, seeds, 1, mesh)
    return sp.hash_long_sequence(dev, K, 1, mesh)


def sp_matches(genome, hashes, valid, seeds=None, starts=(0,)) -> bool:
    import jax

    from nthash_tpu import oracle

    n = 128
    for s in starts:
        got = to_u64(jax.tree_util.tree_map(lambda x: x[s:s + n], hashes[0]))
        if seeds:
            _, _, ext = oracle.hash_all_windows_seeds(
                genome[s:s + n + len(seeds[0]) - 1], seeds, 1)
            v_ok = True
        else:
            _, _, ext, v = oracle.hash_all_windows(genome[s:s + n + K - 1],
                                                   K, 1)
            v_ok = np.array_equal(np.asarray(valid[s:s + n]), v)
        if not (np.array_equal(got, ext[:, 0]) and v_ok):
            return False
    return True


def phase_sp(genome):
    import jax.numpy as jnp

    from nthash_tpu.parallel import sp
    from nthash_tpu.parallel.mesh import SEQ_AXIS, device_mesh

    mesh = device_mesh(1, SEQ_AXIS)
    codes = jnp.asarray(genome)
    hashes, valid = sp_hashes(codes, mesh)
    tile = sp.pick_tile(sp.shard_sequence(codes, mesh, k=K).shape[0], K)
    ok = sp_matches(genome, hashes, valid, starts=(0, 5 * tile - 64))
    del hashes, valid
    seconds = best_time(lambda c: sp_hashes(c, mesh), codes)
    report("sp", seconds, (GENOME_LEN - K + 1) / seconds, "k-mers/s",
           "oracle at the head and across a pseudo-read boundary", ok)
    hashes, valid = sp_hashes(codes, mesh, SEEDS)
    ok = sp_matches(genome, hashes, valid, seeds=SEEDS)
    del hashes, valid
    seconds = best_time(lambda c: sp_hashes(c, mesh, SEEDS), codes)
    report("spseed", seconds, (GENOME_LEN - len(SEEDS[0]) + 1) / seconds,
           "windows/s", f"oracle spaced-seed hashes {SEEDS} at the head", ok)


def phase_cli():
    from nthash_tpu.__main__ import main as cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli(["hash", "-k", "5", "-n", "3", "TGACTGATCGAGTCGTACTAG"])
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    report("cli", seconds, len(lines) / seconds, "lines/s",
           f"golden first line {CLI_GOLDEN!r}",
           rc == 0 and bool(lines) and lines[0].startswith(CLI_GOLDEN))


def run_one_card(seed: int) -> None:
    rng = np.random.default_rng(seed)
    genome = make_genome(rng, GENOME_LEN)
    with tempfile.TemporaryDirectory(prefix="nthash_smoke_") as tmp:
        head, gh, gv = phase_stream(Path(tmp), rng, genome)
    phase_step(head, gh, gv)
    phase_bloom(head, gh, gv)
    del head
    phase_long(rng, genome)
    phase_sp(genome)
    phase_cli()


def run_cards(seed: int, cards: int) -> None:
    """DP and SP over ``cards`` devices, each against one card."""
    import jax
    import jax.numpy as jnp

    from nthash_tpu.models.pipeline import PipelineConfig, ReadHashingPipeline
    from nthash_tpu.parallel.mesh import SEQ_AXIS, device_mesh

    if len(jax.devices()) < cards:
        raise PhaseFailed(f"--cards {cards}: only {len(jax.devices())} "
                          "devices visible")
    rng = np.random.default_rng(seed)
    genome = make_genome(rng, GENOME_LEN)
    with tempfile.TemporaryDirectory(prefix="nthash_smoke_") as tmp:
        path, slice_path = Path(tmp) / "reads.fq", Path(tmp) / "slice.fq"
        total, head = write_stream(path, rng, genome, MULTI_READS,
                                   GATE_READS)
        fastq_bytes(head).tofile(str(slice_path))
        gh, gv = oracle_windows(head, K, NUM_HASHES)
        sparse = oracle_buckets(gh, gv, STREAM_WIDTH_LOG2)
        rows = {}
        for n in (1, cards):
            cfg = PipelineConfig(k=K, num_hashes=NUM_HASHES,
                                 sketch_width_log2=STREAM_WIDTH_LOG2,
                                 n_devices=n)
            seconds, ok, r = count_stream(cfg, path, MULTI_READS, total,
                                          slice_path, sparse, int(gv.sum()))
            rows[n] = np.asarray(r)
            del r
            report(f"dp{n}", seconds, MULTI_READS / seconds, "reads/s",
                   f"host valid-window count and a {GATE_READS}-read oracle "
                   "slice", ok)
    same = np.array_equal(rows[1], rows[cards])
    del rows
    report(f"dp{cards}v1", 0.0, 0.0, "-", "one-card sketch rows", same)

    codes = jnp.asarray(genome)
    got = {}
    for n in (1, cards):
        mesh = device_mesh(n, SEQ_AXIS)
        hashes, valid = sp_hashes(codes, mesh)
        ok = sp_matches(genome, hashes, valid, starts=(0, GENOME_LEN // 2))
        seconds = best_time(lambda c, m=mesh: sp_hashes(c, m), codes)
        got[n] = (to_u64(hashes[0]), np.asarray(valid))
        report(f"sp{n}", seconds, (GENOME_LEN - K + 1) / seconds,
               "k-mers/s", "oracle at the head and mid-genome", ok)
    w = GENOME_LEN - K + 1
    report(f"sp{cards}v1", 0.0, 0.0, "-", "one-card hashes and validity",
           np.array_equal(got[1][0][:w], got[cards][0][:w])
           and np.array_equal(got[1][1][:w], got[cards][1][:w]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=20240601)
    p.add_argument("--cards", type=int, default=1,
                   help="1: the full smoke; >1: only the multi-device paths")
    args = p.parse_args(argv)

    import jax

    print(f"card    {card_line()}", flush=True)
    print(f"jax     {jax.__version__} {jax.devices()}", flush=True)
    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from nthash_tpu.backend import enable_compile_cache

    enable_compile_cache()
    try:
        if args.cards > 1:
            run_cards(args.seed, args.cards)
        else:
            run_one_card(args.seed)
    except PhaseFailed as e:
        print(f"phase failed: {e}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
