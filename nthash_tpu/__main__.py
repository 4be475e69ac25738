"""Command-line interface: ``python -m nthash_tpu <command>``.

The reference is a library with no CLI; a production streaming framework
needs one. Commands:

- ``hash``:  print ntHash2 hashes for a sequence (or stdin lines).
- ``count``: stream a FASTA/FASTQ file through the distributed
  hash-and-sketch pipeline; print totals and throughput.
"""

from __future__ import annotations

import argparse
import sys


def _cmd_hash(args) -> int:
    from . import NtHash, SeedNtHash

    seqs = args.sequence or [line.strip() for line in sys.stdin if line.strip()]
    for seq in seqs:
        if args.seeds:
            nth = SeedNtHash(seq, tuple(args.seeds), args.num_hashes, args.k)
        else:
            nth = NtHash(seq, args.num_hashes, args.k)
        while nth.roll():
            p = nth.get_pos()
            print(seq[p : p + args.k], *(f"{h:016x}" for h in nth.hashes()))
    return 0


def _cmd_count(args) -> int:
    from .models.pipeline import PipelineConfig, ReadHashingPipeline
    from .utils import metrics

    metrics.configure_logging()
    pipe = ReadHashingPipeline(
        PipelineConfig(k=args.k, num_hashes=args.num_hashes,
                       sketch_width_log2=args.width_log2)
    )
    import time

    t0 = time.time()
    if args.fused:
        # production path: bucket emission in-kernel, scatter-add
        # ingestion, parse thread overlapping device work; no 64-bit hash
        # reaches device memory
        reads = pipe.count_file(args.file, batch_size=args.batch_size,
                                threads=args.threads)
        import numpy as np

        total = int(
            np.asarray(pipe.sketch.rows[0]).astype(np.int64).sum())
        dt = time.time() - t0
        print(f"{reads} reads, {total} valid {args.k}-mers in {dt:.2f}s "
              f"({reads / max(dt, 1e-9):.3g} reads/s) on "
              f"{pipe.mesh.devices.size} device(s)")
        return 0
    total = pipe.run_file(args.file, batch_size=args.batch_size,
                          threads=args.threads)
    dt = time.time() - t0
    print(f"{total} valid {args.k}-mers in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.3g} k-mers/s) on "
          f"{pipe.mesh.devices.size} device(s)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nthash_tpu",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="command", required=True)

    ph = sub.add_parser("hash", help="print hashes of sequences")
    ph.add_argument("sequence", nargs="*", help="sequences (default: stdin)")
    ph.add_argument("-k", type=int, default=32)
    ph.add_argument("-n", "--num-hashes", type=int, default=1)
    ph.add_argument("-s", "--seeds", action="append",
                    help="spaced-seed pattern (repeatable)")
    ph.set_defaults(fn=_cmd_hash)

    pc = sub.add_parser("count", help="stream a FASTA/FASTQ into a sketch")
    pc.add_argument("file")
    pc.add_argument("-k", type=int, default=32)
    pc.add_argument("-n", "--num-hashes", type=int, default=4)
    pc.add_argument("--width-log2", type=int, default=20)
    pc.add_argument("--batch-size", type=int, default=65536)
    pc.add_argument("--fused", action="store_true",
                    help="fused hash->count path (sketch only, fastest)")
    pc.add_argument("--threads", type=int, default=1,
                    help="byte-range shard parse threads (native parser)")
    pc.set_defaults(fn=_cmd_count)

    args = p.parse_args(argv)
    from .backend import enable_compile_cache

    enable_compile_cache()
    try:
        return args.fn(args)
    except (ValueError, FileNotFoundError) as e:
        # reference raise_error prints to stderr and exits 1
        # (reference src/internal.hpp:16-22)
        print(e, file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
