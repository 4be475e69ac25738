"""Device mesh helpers.

The framework has two meaningful parallel axes (SURVEY.md §2.7):
- "reads": data parallelism over independent reads (the moral equivalent of
  the reference's one-iterator-per-thread pattern, nthash.hpp:95-107),
- "seq":   sequence parallelism over position for genome-scale sequences.

Both are expressed as 1-D jax.sharding meshes: the cards of one host are
joined all to all (NVLink), so the mesh follows the algorithm alone;
across hosts, jax.distributed forms one mesh.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

READS_AXIS = "reads"
SEQ_AXIS = "seq"


def device_mesh(n_devices: int | None = None, axis: str = READS_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def initialize_distributed(**kwargs) -> None:
    """Multi-host init: one entry point for forming the cross-host (DCN)
    coordination service. Coordinator address etc. come from the standard
    JAX env vars or kwargs (jax.distributed.initialize).

    Idempotent — a second call is a no-op. Real initialization failures
    propagate (swallowing them would silently degrade a pod job to one
    process). Exercised end-to-end by tests/test_multihost.py.
    """
    if jax.distributed.is_initialized():
        return
    jax.distributed.initialize(**kwargs)
