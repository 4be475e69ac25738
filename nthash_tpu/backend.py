"""The one place that decides what runs on the current JAX backend.

- Hash engine: the Triton k-mer kernel (ops/kmer_pallas.py) on ``gpu``;
  the XLA scan engine (ops/kmer_jnp.py) on every other backend. Nothing
  falls back to the Pallas interpreter: ``interpret=True`` is an explicit,
  test-only argument of the kernel, and asking for the kernel where there
  is no GPU raises.
- :func:`hash_windows_tm` and :func:`bucket_rows` run the chosen engine
  for the batched paths (parallel/dp.py, parallel/sp.py).
- Host facade: the sequence length at which ``engine="auto"`` moves from
  the host oracle to the device engine (api.py).
- Compile cache: :func:`enable_compile_cache`, called by the programs
  that run on the card (``chip_smoke.py``, ``bench.py``, the CLI).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

#: Engine names accepted by ``engine=`` arguments.
ENGINES = ("auto", "pallas", "jnp")

#: Sequence length at/above which the facade's "auto" engine uses the
#: batched JAX engine on an accelerator; below it the host oracle avoids
#: device round-trips for tiny inputs. On the CPU backend the XLA engine
#: beats the numpy oracle already at 512 windows.
AUTO_DEVICE_THRESHOLD = 2048
AUTO_DEVICE_THRESHOLD_CPU = 512


def platform() -> str:
    """The default JAX backend's platform name ("gpu", "cpu", ...)."""
    return jax.default_backend()


def require_gpu(what: str) -> None:
    """Raise unless the default backend is a GPU."""
    if platform() != "gpu":
        raise RuntimeError(
            f"{what} is compiled for the GPU only, but the JAX backend is "
            f"{platform()!r}; use engine='jnp' (or interpret=True in tests)"
        )


def hash_engine(engine: str = "auto") -> str:
    """Resolve an ``engine=`` argument to "pallas" (the Triton kernel) or
    "jnp" (the XLA scan). "auto" picks the kernel on a GPU and the scan
    elsewhere; an explicit "pallas" off the GPU raises."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    if engine == "auto":
        return "pallas" if platform() == "gpu" else "jnp"
    if engine == "pallas":
        require_gpu("engine='pallas'")
    return engine


def use_kernel(engine: str = "auto", interpret: bool = False) -> bool:
    """True when the Triton kernel runs: on a GPU for "auto"/"pallas", or
    in the Pallas interpreter when a test passes ``interpret=True``."""
    if interpret:
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}")
        return engine != "jnp"
    return hash_engine(engine) == "pallas"


def hash_windows_tm(codes, k: int, num_hashes: int, *,
                    engine: str = "auto", interpret: bool = False):
    """[B, L] codes -> (list of ``num_hashes`` U64 [W, B], valid [W, B]):
    every window's canonical + nte64 hashes in the time-major layout,
    by the engine :func:`use_kernel` picks."""
    from .ops.kmer_jnp import hash_kmers, window_valid_tm
    from .u64 import U64

    b = codes.shape[0]
    if use_kernel(engine, interpret):
        from .ops.kmer_pallas import hash_kmers_tm, prepare_codes

        tm = prepare_codes(codes)
        res = hash_kmers_tm(tm, k, num_hashes, interpret=interpret)
        return ([U64(h.hi[:, :b], h.lo[:, :b]) for h in res],
                window_valid_tm(tm, k)[:, :b])
    res = hash_kmers(codes, k, num_hashes)
    return ([U64(res.hashes.hi[..., i].T, res.hashes.lo[..., i].T)
             for i in range(num_hashes)], res.valid.T)


def bucket_rows(codes, k: int, num_rows: int, width_log2: int, *,
                interpret: bool = False) -> list:
    """[B, L] codes -> ``num_rows`` int32 arrays [W, R >= B] of bucket
    indices ``hash_r & (2**width_log2 - 1)``; invalid windows (and padded
    reads) carry the out-of-range sentinel ``2**width_log2``. On the GPU
    the kernel emits them directly, so no 64-bit hash reaches memory."""
    if use_kernel(interpret=interpret):
        from .ops.kmer_pallas import hash_kmers_tm, prepare_codes

        return hash_kmers_tm(prepare_codes(codes), k, num_rows,
                             emit_buckets=width_log2, interpret=interpret)
    import jax.numpy as jnp

    from .ops.kmer_jnp import hash_kmers

    res = hash_kmers(codes, k, num_rows)
    mask = jnp.uint32((1 << width_log2) - 1)
    return [
        jnp.where(res.valid, (res.hashes.lo[..., r] & mask).astype(jnp.int32),
                  jnp.int32(1 << width_log2)).T
        for r in range(num_rows)
    ]


def auto_device_threshold() -> int:
    """Facade length threshold for "auto" on the current backend."""
    return (AUTO_DEVICE_THRESHOLD_CPU if platform() == "cpu"
            else AUTO_DEVICE_THRESHOLD)


def compile_cache_dir() -> str | None:
    """Where the persistent compile cache lives: ``JAX_COMPILATION_CACHE_DIR``
    when set; else ``<checkout>/.jax_cache`` when the package runs from a
    source checkout (``pyproject.toml`` beside it), a fixed path so that a
    later run finds what an earlier one cached; else None, and an
    installed package leaves JAX's own default alone."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = Path(__file__).resolve().parent.parent
    if (root / "pyproject.toml").is_file():
        return str(root / ".jax_cache")
    return None


def enable_compile_cache() -> str | None:
    """Turn on JAX's persistent compile cache at :func:`compile_cache_dir`
    and return it. When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already
    reads it and nothing else is set here; outside a checkout nothing is
    set either."""
    path = compile_cache_dir()
    if path is not None and not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
