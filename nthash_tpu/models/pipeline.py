"""The flagship end-to-end model: streaming reads -> hashes -> merged sketch.

Mirrors the north-star deployment (BASELINE.json): FASTA/FASTQ read batches
stream data-parallel across chips/hosts, every k-mer window is hashed
(canonical + nte64 extensions, bit-exact ntHash2), and per-chip count-min
sketches merge via all-reduce. This is the "training step" the multichip
dry-run compiles.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..models import sketch as cms
from ..parallel import dp
from ..parallel.mesh import device_mesh
from ..u64 import U64


@dataclass
class PipelineConfig:
    k: int = 32
    num_hashes: int = 4
    sketch_width_log2: int = 20
    n_devices: int | None = None  # default: all visible devices
    engine: str = "auto"  # "auto": Triton kernel on a GPU, jnp elsewhere
    #: Hash output layout. True (default) returns the kernel's native
    #: window-major [W, B] per-hash arrays, skipping the relayout to the
    #: batch-major [B, W, H] stack. Set False for the batch-major layout.
    time_major: bool = True
    #: count_file only: pack each batch to 2 bits/base + an N bitmap on
    #: the host (inside the prefetch thread, overlapped) and unpack on
    #: device — ~3.6x fewer bytes over the host->device link, losslessly
    #: (the sketch is bit-identical either way). Off by default: whether
    #: the smaller transfer pays for the on-device unpack has not been
    #: measured on the GPU.
    pack_h2d: bool = False


class ReadHashingPipeline:
    """Stateful convenience wrapper around the distributed hash+sketch step.

    >>> pipe = ReadHashingPipeline(PipelineConfig(k=32, num_hashes=4))
    >>> hashes, valid = pipe.step(codes_batch)   # [B, W, H] hashes
    >>> counts = pipe.query(hashes)              # count-min estimates
    """

    def __init__(self, config: PipelineConfig = PipelineConfig()):
        self.config = config
        self.mesh = device_mesh(config.n_devices)
        self.sketch = cms.CountMinSketch.zeros(
            config.num_hashes, config.sketch_width_log2
        )

    def step(self, codes: np.ndarray | jnp.ndarray):
        """Hash one [B, L] batch (B divisible by mesh size) and fold its
        k-mers into the global sketch.

        Returns (hashes, valid): with the default time-major config, a
        list of ``num_hashes`` U64 [W, B] plus valid [W, B] (the fast
        layout); with ``time_major=False``, one U64 [B, W, H] plus valid
        [B, W]."""
        cfg = self.config
        codes = dp.shard_reads(jnp.asarray(codes), self.mesh)
        hashes, valid, self.sketch = dp.hash_and_sketch(
            codes,
            self.sketch,
            cfg.k,
            cfg.num_hashes,
            cfg.sketch_width_log2,
            self.mesh,
            cfg.engine,
            time_major=cfg.time_major,
        )
        return hashes, valid

    def query(self, hashes) -> jnp.ndarray:
        """Count-min multiplicity estimates for window hashes in either
        step() layout (a per-hash U64 list or one stacked U64)."""
        wlog = self.config.sketch_width_log2
        if isinstance(hashes, U64):  # U64 is itself a (named) tuple
            return cms.query(self.sketch, hashes, wlog)
        return cms.query_rows(self.sketch, hashes, wlog)

    def run_file(self, path, batch_size: int = 65536,
                 read_length: int | None = None, prefetch: int = 2,
                 threads: int = 1):
        """Stream a FASTA/FASTQ file through the full hash+sketch pipeline.

        Parsing runs in a background thread (io/stream.Prefetcher over the
        native C++ parser when available) — or ``threads`` byte-range
        shard threads in parallel (io/stream.stream_code_batches_parallel)
        — and per-batch valid-k-mer counts accumulate as *device* scalars;
        the single host sync happens at the end, so parse / H2D / compute
        overlap across the whole stream. Returns the total number of
        valid k-mers hashed.
        """
        from ..io.stream import (
            Prefetcher, stream_code_batches, stream_code_batches_parallel,
        )

        batch_size += (-batch_size) % self.mesh.devices.size
        if threads > 1:
            src = stream_code_batches_parallel(
                path, batch_size, read_length, threads=threads)
        else:
            src = stream_code_batches(path, batch_size, read_length)
        counts = []
        with Prefetcher(src, depth=prefetch) as pf:
            for batch, _ in pf:
                _, valid = self.step(batch)
                counts.append(jnp.sum(valid.astype(jnp.int32)))
        return int(np.sum([np.asarray(c) for c in counts], dtype=np.int64))

    def count_file(self, path, batch_size: int = 1 << 18,
                   read_length: int | None = None, prefetch: int = 2,
                   checkpoint_path=None, checkpoint_every: int = 0,
                   threads: int = 1):
        """Stream a file through the *fused* hash->count pipeline (bucket
        emission in-kernel, scatter-add ingestion; no 64-bit hash reaches
        device memory) — the production streaming configuration
        (BASELINE config 5).

        Same overlap structure as :meth:`run_file`; every batch has a
        fixed shape so the distributed step compiles exactly once.
        ``threads > 1`` parses byte-range shards of the file in parallel
        (order-nondeterministic; the sketch is order-invariant).

        ``checkpoint_path`` + ``checkpoint_every`` (batches) enable
        crash recovery: the sketch and the file offset just past the last
        counted record persist via utils.checkpoint (FN_NAME-tagged), and
        a rerun with the same parameters *seeks* to that offset — resume
        cost is O(1), not a re-parse of the counted prefix (VERDICT r3
        weak #6) — and produces a sketch bit-identical to an
        uninterrupted run (k-mer multisets, not batch boundaries, define
        it). The reference's analogue is that its iterator state (pos,
        fwd, rev) is resumable by construction (reference
        nthash.hpp:72-78); here the carried state is the sketch plus the
        stream offset. Checkpointing requires the deterministic serial
        parse (``threads == 1``) and the native parser.

        Returns (reads_streamed including any resumed prefix).
        """
        from pathlib import Path

        from ..io.stream import (
            Prefetcher, stream_code_batches, stream_code_batches_parallel,
        )
        from ..parallel import dp
        from ..utils import checkpoint

        batch_size += (-batch_size) % self.mesh.devices.size
        cfg = self.config
        total = 0
        start_offset = 0
        with_ckpt = checkpoint_path is not None
        if with_ckpt and threads > 1:
            raise ValueError(
                "checkpointing requires the deterministic serial parse "
                "(threads=1); parallel shard order is nondeterministic"
            )
        # Run-context fingerprint: resuming with a different input file,
        # batch size, k, or sketch geometry must fail loudly, not merge
        # mismatched state into the sketch (ADVICE r3).
        src = Path(path)
        ctx = {
            "input": f"{src.name}:{src.stat().st_size}",
            "batch_size": int(batch_size),
            "k": int(cfg.k),
            "num_hashes": int(cfg.num_hashes),
            "sketch_width_log2": int(cfg.sketch_width_log2),
        }
        if with_ckpt and Path(checkpoint_path).exists():
            state = checkpoint.load(checkpoint_path, {
                "rows": self.sketch.rows,
                "reads": np.int64(0),
                "offset": np.int64(0),
            }, expect_context=ctx)
            self.sketch = cms.CountMinSketch(jnp.asarray(state["rows"]))
            total = int(state["reads"])
            start_offset = int(state["offset"])

        def save_ckpt(offset):
            jax.block_until_ready(self.sketch.rows)
            checkpoint.save(checkpoint_path, {
                "rows": self.sketch.rows,
                "reads": np.int64(total),
                "offset": np.int64(offset),
            }, context=ctx)

        if threads > 1:
            src_it = stream_code_batches_parallel(
                path, batch_size, read_length, threads=threads)
        else:
            src_it = stream_code_batches(
                path, batch_size, read_length,
                start_offset=start_offset, with_offsets=with_ckpt)
        if cfg.pack_h2d:
            from ..io.stream import packed_batches

            src_it = packed_batches(src_it)
        done = 0
        with Prefetcher(src_it, depth=prefetch) as pf:
            for item in pf:
                batch, n = item[0], item[1]
                if cfg.pack_h2d:
                    packed, nmask, length = batch
                    self.sketch = dp.fused_count_packed(
                        dp.shard_reads(jnp.asarray(packed), self.mesh),
                        dp.shard_reads(jnp.asarray(nmask), self.mesh),
                        self.sketch, cfg.k, length, self.mesh,
                    )
                else:
                    codes = dp.shard_reads(jnp.asarray(batch), self.mesh)
                    self.sketch = dp.fused_count(
                        codes, self.sketch, cfg.k, self.mesh)
                total += n
                done += 1
                if (with_ckpt and checkpoint_every
                        and done % checkpoint_every == 0):
                    save_ckpt(item[2])
        jax.block_until_ready(self.sketch.rows)
        if with_ckpt:
            save_ckpt(item[2] if done else start_offset)
        return total
