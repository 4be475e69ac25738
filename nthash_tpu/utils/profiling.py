"""Tracing / profiling harness (SURVEY.md §5).

The reference's only instrumentation is wall-clock timing in its benchmark
(reference examples/benchmark.cpp:32-42). Here:

- :func:`timeit` — dispatch-pipelined timing (queue N async dispatches,
  fence once with ``jax.block_until_ready``, divide), so per-call host
  dispatch overlaps device work the way a pipelined caller sees it.
- :func:`trace` — context manager around ``jax.profiler`` producing a
  TensorBoard/XProf trace directory for per-kernel analysis.
- :func:`throughput` — hashes/s / k-mers/s bookkeeping for benchmark
  reporting.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import jax


@dataclass(frozen=True)
class Timing:
    """Result of a timed run."""

    seconds_per_call: float
    calls: int

    def per_second(self, items_per_call: float) -> float:
        return items_per_call / self.seconds_per_call


def _sync(out):
    """Fence on device completion of every array leaf in ``out``."""
    return jax.block_until_ready(out)


def timeit(fn, *args, calls: int = 16, warmup: int = 1) -> Timing:
    """Time ``fn(*args)`` with async dispatch pipelining.

    ``fn`` should be jitted; compile cost is excluded by the warm-up calls.
    All ``calls`` dispatches are queued back-to-back and synchronized once,
    so host->device round-trip latency amortizes away (the device executes
    the queue serially).
    """
    for _ in range(warmup):
        _sync(fn(*args))
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(calls)]
    _sync(outs[-1])
    dt = (time.perf_counter() - t0) / calls
    return Timing(seconds_per_call=dt, calls=calls)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace (open with TensorBoard / XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def throughput(timing: Timing, *, windows: int, num_hashes: int = 1) -> dict:
    """Standard benchmark bookkeeping: k-mers/s and hashes/s."""
    kmers = timing.per_second(windows)
    return {
        "seconds_per_call": timing.seconds_per_call,
        "kmers_per_s": kmers,
        "hashes_per_s": kmers * num_hashes,
    }
