"""Test configuration: force CPU with a virtual 8-device mesh.

Correctness tests run on the CPU; the compiled GPU kernels run in
chip_smoke.py and bench.py on the card, and in the ``gpu``-marked tests,
which skip here. To run those on a GPU host:

    NTHASH_TESTS_ON_GPU=1 python -m pytest tests -m gpu

Multi-device sharding tests use the standard trick of faking 8 CPU devices.

Note: env vars alone are not enough here because installed pytest plugins
(jaxtyping) import jax before this conftest runs; jax.config.update works
as long as no backend has been initialized yet.
"""

import os

import jax

if not os.environ.get("NTHASH_TESTS_ON_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """For ``gpu``-marked tests: skip unless JAX's backend is a GPU (decided
    here, at run time, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (the compiled Triton kernel has no CPU "
                    "mode); run with NTHASH_TESTS_ON_GPU=1 on a GPU host")


@pytest.fixture(autouse=True)
def _eager_interpret(request):
    """Run slow-marked tests under jax.disable_jit(): eager evaluation of
    the interpreted kernels skips XLA:CPU's compile of the whole
    interpreted graph. Results are bit-identical — these tests compare
    exact integer arrays."""
    if request.node.get_closest_marker("slow"):
        with jax.disable_jit():
            yield
    else:
        yield
