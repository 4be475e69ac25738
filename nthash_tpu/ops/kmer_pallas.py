"""Pallas (Triton route) GPU kernel for the k-mer rolling-hash hot path.

Design for the GPU's execution model:

- Reads are laid out **time-major** ``[L, R]``, one read per thread and
  ``BLOCK_R`` reads per program, so each time step loads one coalesced row
  of codes.
- A ``fori_loop`` over time runs inside the program: a warm-up loop of
  ``k - 1`` roll-in steps with no stores, then the steady loop that rolls
  one base in and one out and stores one output row per step. The
  fwd/rev limb pairs stay in registers for the whole loop; an XLA
  ``lax.scan`` (ops/kmer_jnp.py) instead moves the ``[B]`` state through
  device memory and launches work on every base.
- The loop has no fast-memory bound, so one kernel serves 150 bp reads
  and 10 kbp reads alike. When there are too few reads to fill the card,
  a second grid axis splits each read's windows into time chunks; each
  chunk rolls its own ``k - 1``-base warm-up, so nothing carries between
  programs (GPU blocks run in no order).
- With ``emit_buckets`` the kernel writes int32 bucket indices with the
  window's validity fused in, so no 64-bit hash reaches device memory on
  the counting path.

Bit-exactness: identical recurrence to ops/kmer_jnp.py (same u64 limb ops),
which is fuzz-tested against the host oracle and the reference golden
vectors. The kernel runs under ``interpret=True`` in the CPU tests; the
compiled kernel runs only on a GPU (:func:`nthash_tpu.backend.require_gpu`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .. import u64
from ..u64 import U64
from .kmer_jnp import PlaneTables, plane_tables

#: Reads per program, one per thread (a power of two for Triton), and warps
#: per program. 128/256/512 reads x 2/4/8 warps measured within 10% of each
#: other on an H100 (PERF.md).
BLOCK_R = 256
NUM_WARPS = 4
#: Programs to aim for before splitting reads into time chunks (a few
#: waves over the card's 132 SMs).
TARGET_PROGRAMS = 1024


def pick_time_chunk(windows: int, k: int, reads: int) -> int:
    """Windows per program along time: all of them when the read blocks
    alone give ``TARGET_PROGRAMS`` programs, else fewer, but never under
    ``8 * (k - 1)`` so the per-chunk warm-up stays below 1/8 of the work."""
    blocks = max(reads // BLOCK_R, 1)
    chunks = -(-TARGET_PROGRAMS // blocks)
    chunk = -(-windows // chunks)
    return min(windows, max(chunk, 8 * (k - 1), 1))


def _kernel(in_ref, *out_refs, k: int, num_hashes: int, windows: int,
            chunk: int, tabs: PlaneTables, emit_fwd_rev: bool,
            emit_buckets: int | None):
    start = pl.program_id(1) * chunk          # first window of this program
    stop = jnp.minimum(start + chunk, windows)

    def load(t):
        return in_ref[t, :].astype(jnp.int32)

    def roll_in(t, fwd, rev, inv):
        c_in = load(t)
        fwd = u64.xor(u64.srol1(fwd), u64.lookup5(c_in, tabs.fwd_in))
        rev = u64.xor(u64.sror1(rev), u64.lookup5(c_in, tabs.rev_in))
        return fwd, rev, inv + (c_in >= 4).astype(jnp.int32)

    def warm(t, carry):
        return roll_in(t, *carry)

    def steady(w, carry):
        t = w + k - 1
        fwd, rev, inv = roll_in(t, *carry)
        # the base leaving the window was rolled in only if it lies in this
        # program's span; before that it counts as N (zero seed)
        live = t - k >= start
        c_out = jnp.where(live, load(jnp.maximum(t - k, start)), 4)
        fwd = u64.xor(fwd, u64.lookup5(c_out, tabs.fwd_out))
        # sror(x ^ y) == sror(x) ^ sror(y): the leaving base's reverse term
        # uses the table with the sror folded in
        rev = u64.xor(rev, u64.lookup5(c_out, tabs.rev_out_r))
        inv = inv - (live & (c_out >= 4)).astype(jnp.int32)
        canon = u64.add(fwd, rev)
        ext = u64.extend_hashes(canon, k, num_hashes)
        if emit_buckets is None:
            if emit_fwd_rev:
                ext = ext + [fwd, rev]
            for i, e in enumerate(ext):
                out_refs[2 * i][w, :] = e.hi
                out_refs[2 * i + 1][w, :] = e.lo
        else:
            # invalid windows emit the out-of-range sentinel 2**emit_buckets,
            # which scatter ingestion drops
            mask = jnp.uint32((1 << emit_buckets) - 1)
            for i, e in enumerate(ext):
                b = (e.lo & mask).astype(jnp.int32)
                out_refs[i][w, :] = jnp.where(
                    inv == 0, b, jnp.int32(1 << emit_buckets))
        return fwd, rev, inv

    zero = U64.zeros((BLOCK_R,))
    carry = (zero, zero, jnp.zeros((BLOCK_R,), jnp.int32))
    carry = jax.lax.fori_loop(start, start + k - 1, warm, carry)
    jax.lax.fori_loop(start, stop, steady, carry)


@partial(
    jax.jit,
    static_argnames=("k", "num_hashes", "emit_fwd_rev", "emit_buckets",
                     "interpret"),
)
def hash_kmers_tm(
    codes_tm: jnp.ndarray,
    k: int,
    num_hashes: int = 1,
    *,
    emit_fwd_rev: bool = False,
    emit_buckets: int | None = None,
    interpret: bool = False,
):
    """Hash all k-mer windows of time-major coded reads.

    Args:
      codes_tm: [L, R] uint8 or int32 base codes (0-3 valid, 4 invalid),
        R a multiple of ``BLOCK_R``. :func:`prepare_codes` gives this
        layout from the natural [B, L] uint8 batch.
      k: k-mer size.
      num_hashes: canonical + nte64 extensions per window.
      emit_fwd_rev: additionally emit the forward and reverse hashes.
      emit_buckets: if set (a width_log2), emit int32 bucket indices
        ``hash & (2**emit_buckets - 1)`` instead of 64-bit hashes, with
        invalid windows (any non-ACGTU base) fused in-kernel to the
        out-of-range sentinel ``2**emit_buckets`` — the fast path of the
        hash -> count pipeline (the consumer the reference delegates to
        btllib, include/nthash/nthash.hpp:56-58).
      interpret: run the kernel body in the Pallas interpreter (tests on
        the CPU only).

    Returns:
      Without emit_buckets: list of U64 with arrays of shape [W, R]:
      canonical + extensions (+ fwd, rev if requested) for every window.
      Window w of read r is at [w, r]; validity must be derived separately
      (kmer_jnp.window_valid_tm). With emit_buckets: list of int32 arrays [W, R] of
      bucket indices (validity already fused).
    """
    length, reads = codes_tm.shape
    if length < k:
        raise ValueError(f"sequence length ({length}) is smaller than k ({k})")
    if emit_buckets is not None and emit_fwd_rev:
        raise ValueError("emit_buckets and emit_fwd_rev are exclusive")
    if reads % BLOCK_R:
        raise ValueError(f"R ({reads}) must be a multiple of {BLOCK_R}")
    if not interpret:
        from ..backend import require_gpu

        require_gpu("the Triton k-mer kernel")
    w = length - k + 1
    nout = num_hashes + (2 if emit_fwd_rev else 0)
    out_arrays = nout if emit_buckets is not None else 2 * nout
    chunk = pick_time_chunk(w, k, reads)
    out_dtype = jnp.int32 if emit_buckets is not None else jnp.uint32
    outs = pl.pallas_call(
        partial(
            _kernel, k=k, num_hashes=num_hashes, windows=w, chunk=chunk,
            tabs=plane_tables(k), emit_fwd_rev=emit_fwd_rev,
            emit_buckets=emit_buckets,
        ),
        grid=(reads // BLOCK_R, -(-w // chunk)),
        in_specs=[pl.BlockSpec((length, BLOCK_R), lambda i, c: (0, i))],
        out_specs=tuple(
            pl.BlockSpec((w, BLOCK_R), lambda i, c: (0, i))
            for _ in range(out_arrays)
        ),
        out_shape=tuple(
            jax.ShapeDtypeStruct((w, reads), out_dtype)
            for _ in range(out_arrays)
        ),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="kmer_roll",
    )(codes_tm)
    if emit_buckets is not None:
        return list(outs)
    return [U64(outs[2 * i], outs[2 * i + 1]) for i in range(nout)]


def pad_reads(n: int) -> int:
    """Smallest multiple of ``BLOCK_R`` >= n."""
    return -(-n // BLOCK_R) * BLOCK_R


@jax.jit
def prepare_codes(codes: jnp.ndarray) -> jnp.ndarray:
    """[B, L] codes -> padded time-major [L, R] uint8 for the kernel
    (codes above 4 clamp to 4; padded reads are all-invalid)."""
    b, _ = codes.shape
    r = pad_reads(b)
    codes = jnp.minimum(codes.astype(jnp.uint8), jnp.uint8(4))
    if r != b:
        codes = jnp.pad(codes, ((0, r - b), (0, 0)), constant_values=4)
    return codes.T
