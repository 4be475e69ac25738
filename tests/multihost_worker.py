"""Worker for the 2-process DCN test (run by tests/test_multihost.py).

Each process owns 4 virtual CPU devices; the two processes form one
8-device mesh connected through jax.distributed's coordination service —
the same cross-host coordination path (gRPC) a multi-host deployment uses,
exercising parallel.mesh.initialize_distributed for real.

Usage: python multihost_worker.py <process_id> <num_processes> <port>
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

# an installed plugin may have imported jax already; config updates still
# work until a backend is initialized — the same trick as tests/conftest.py.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)


def main() -> None:
    proc, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    from nthash_tpu.parallel.mesh import READS_AXIS, initialize_distributed

    initialize_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=proc,
    )
    assert jax.process_count() == nproc, (
        f"expected {nproc} processes, got {jax.process_count()}"
    )
    assert len(jax.devices()) == 4 * nproc, len(jax.devices())

    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from nthash_tpu import oracle
    from nthash_tpu.models import sketch as cms
    from nthash_tpu.parallel import dp

    B, L, k, h, wl = 16, 40, 9, 2, 10
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 5, size=(B, L), dtype=np.uint8)  # same on all procs

    mesh = Mesh(np.array(jax.devices()), (READS_AXIS,))
    sharding = NamedSharding(mesh, P(READS_AXIS, None))
    garr = jax.make_array_from_callback(
        (B, L), sharding, lambda idx: codes[idx]
    )
    sk0 = cms.CountMinSketch.zeros(h, wl)
    _, _, merged = dp.hash_and_sketch(garr, sk0, k, h, wl, mesh, "jnp")
    rows = np.asarray(jax.device_get(merged.rows))

    # host-oracle expectation over the full (unsharded) batch
    exp = np.zeros((h, 1 << wl), np.int32)
    mask = np.uint64((1 << wl) - 1)
    for b in range(B):
        _, _, ext, valid = oracle.hash_all_windows(codes[b], k, h)
        for w_i in range(ext.shape[0]):
            if valid[w_i]:
                for r in range(h):
                    exp[r, int(ext[w_i, r] & mask)] += 1
    assert np.array_equal(rows, exp), "DCN-merged sketch != host oracle"
    print(f"MULTIHOST_OK p{proc}", flush=True)


if __name__ == "__main__":
    main()
