"""Data-parallel read sharding: the scale-out axis the reference lacks.

The reference parallelizes by letting callers copy one iterator per thread
(nthash.hpp:95-107). Here a [B, L] read batch is sharded over the "reads"
mesh axis with shard_map; each device hashes its shard with the batched
engine and per-device count-min sketches merge with one psum (an NCCL
all-reduce over NVLink on one host).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .. import backend
from ..u64 import U64
from ..models import sketch as cms
from .mesh import READS_AXIS


def shard_reads(codes: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Place a [B, L] batch with B sharded over the reads axis."""
    return jax.device_put(codes, NamedSharding(mesh, P(READS_AXIS, None)))


@partial(
    jax.jit,
    static_argnames=("k", "mesh", "interpret"),
)
def fused_count(
    codes: jnp.ndarray,
    sketch: cms.CountMinSketch,
    k: int,
    mesh: Mesh,
    *,
    interpret: bool = False,
) -> cms.CountMinSketch:
    """Distributed fused counting: per shard, the hash engine emits int32
    bucket indices with validity fused (on the GPU the Triton kernel, so
    no 64-bit hash reaches device memory), one scatter-add per sketch row
    counts them, then one psum merges the per-device sketches.

    codes: [B, L] uint8 sharded over the reads axis; one sketch row per
    nte64 hash. Returns the merged CountMinSketch (replicated).
    ``interpret`` runs the kernel in the Pallas interpreter (tests only).
    """
    num_rows, width = sketch.rows.shape
    width_log2 = width.bit_length() - 1

    def local_step(local_codes, local_rows):
        counts = cms.update_from_buckets(
            cms.CountMinSketch(jnp.zeros_like(local_rows)),
            backend.bucket_rows(local_codes, k, num_rows, width_log2,
                                interpret=interpret),
            emitted_width_log2=width_log2,
        ).rows
        return local_rows + jax.lax.psum(counts, READS_AXIS)

    rows = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(READS_AXIS, None), P()),
        out_specs=P(),
        check_vma=False,
    )(codes, sketch.rows)
    return cms.CountMinSketch(rows)


def unpack_codes(packed: jnp.ndarray, nmask: jnp.ndarray,
                 length: int) -> jnp.ndarray:
    """Invert io.stream.pack_codes on device: (2-bit planes [B, L4/4],
    N bitmap [B, L8/8]) -> [B, length] uint8 codes (0-4)."""
    b = packed.shape[0]
    p = packed.astype(jnp.int32)
    codes = jnp.stack([(p >> (2 * r)) & 3 for r in range(4)],
                      axis=-1).reshape(b, -1)                # [B, L4]
    n = nmask.astype(jnp.int32)
    nbits = jnp.stack([(n >> r) & 1 for r in range(8)],
                      axis=-1).reshape(b, -1)[:, : codes.shape[1]]
    return jnp.where(nbits != 0, 4, codes)[:, :length].astype(jnp.uint8)


@partial(jax.jit, static_argnames=("k", "length", "mesh", "interpret"))
def fused_count_packed(
    packed: jnp.ndarray,
    nmask: jnp.ndarray,
    sketch: cms.CountMinSketch,
    k: int,
    length: int,
    mesh: Mesh,
    *,
    interpret: bool = False,
) -> cms.CountMinSketch:
    """:func:`fused_count` over a pack_codes-compressed batch: the wire
    carries 2 bits/base + 1 N-bit/base (~3.6x less host->device traffic),
    and the codes are unpacked on device inside each shard."""
    num_rows, width = sketch.rows.shape
    width_log2 = width.bit_length() - 1

    def local_step(local_packed, local_nmask, local_rows):
        codes = unpack_codes(local_packed, local_nmask, length)
        counts = cms.update_from_buckets(
            cms.CountMinSketch(jnp.zeros_like(local_rows)),
            backend.bucket_rows(codes, k, num_rows, width_log2,
                                interpret=interpret),
            emitted_width_log2=width_log2,
        ).rows
        return local_rows + jax.lax.psum(counts, READS_AXIS)

    rows = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(READS_AXIS, None), P(READS_AXIS, None), P()),
        out_specs=P(),
        check_vma=False,
    )(packed, nmask, sketch.rows)
    return cms.CountMinSketch(rows)


@partial(
    jax.jit,
    static_argnames=(
        "k", "num_hashes", "width_log2", "mesh", "engine", "time_major",
        "interpret",
    ),
)
def hash_and_sketch(
    codes: jnp.ndarray,
    sketch: cms.CountMinSketch,
    k: int,
    num_hashes: int,
    width_log2: int,
    mesh: Mesh,
    engine: str = "auto",
    time_major: bool = False,
    *,
    interpret: bool = False,
):
    """One full distributed step: hash the sharded batch, update the sketch,
    all-reduce the sketch across devices.

    ``engine``: "auto" (the Triton kernel on a GPU, the XLA scan
    elsewhere), "jnp", or "pallas" (GPU only; ``interpret=True`` runs it
    in the Pallas interpreter for tests).

    ``time_major=True`` returns hashes in the kernel's native window-major
    layout — a *list* of ``num_hashes`` U64 with [W, B] arrays (B sharded
    over reads) plus valid [W, B] — which skips the relayout to the
    batch-major [B, W, H] stack. The sketch update itself is layout-free
    either way (histograms are order-invariant).

    Returns (hashes, valid, merged CountMinSketch replicated); hashes are
    one U64 [B, W, H] by default, a list of per-hash U64 [W, B] when
    ``time_major``.
    """
    mask = jnp.uint32((1 << width_log2) - 1)
    sentinel = jnp.int32(1 << width_log2)

    def local_step(local_codes, local_rows):
        res, valid = backend.hash_windows_tm(
            local_codes, k, num_hashes, engine=engine,
            interpret=interpret)                        # H x U64 [W, B]
        local_sketch = cms.update_from_buckets(
            cms.CountMinSketch(jnp.zeros_like(local_rows)),
            [jnp.where(valid, (h.lo & mask).astype(jnp.int32), sentinel)
             for h in res],
            emitted_width_log2=width_log2,
        )
        if time_major:
            his = tuple(h.hi for h in res)
            los = tuple(h.lo for h in res)
        else:
            his = (jnp.stack([h.hi for h in res], -1).transpose(1, 0, 2),)
            los = (jnp.stack([h.lo for h in res], -1).transpose(1, 0, 2),)
            valid = valid.T
        merged = jax.lax.psum(local_sketch.rows, READS_AXIS)
        return his, los, valid, local_rows + merged

    nh = num_hashes if time_major else 1
    shard = P(None, READS_AXIS) if time_major else P(READS_AXIS)
    his, los, valid, rows = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(READS_AXIS, None), P()),
        out_specs=(
            tuple(shard for _ in range(nh)),
            tuple(shard for _ in range(nh)),
            shard,
            P(),
        ),
        check_vma=False,
    )(codes, sketch.rows)
    if time_major:
        return (
            [U64(h, lo) for h, lo in zip(his, los)],
            valid,
            cms.CountMinSketch(rows),
        )
    return U64(his[0], los[0]), valid, cms.CountMinSketch(rows)
