"""nthash_tpu.backend: engine choice per backend, the dispatch helpers,
the compile-cache location, and the native parser's build key."""

from pathlib import Path

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from nthash_tpu import backend, oracle
from nthash_tpu.io import native_loader

REPO = Path(__file__).resolve().parent.parent


def test_auto_engine_is_scan_on_cpu():
    assert backend.platform() == "cpu"
    assert backend.hash_engine() == "jnp"
    assert not backend.use_kernel()


def test_engine_per_backend(monkeypatch):
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    assert backend.hash_engine("auto") == "pallas"
    assert backend.hash_engine("pallas") == "pallas"
    assert backend.hash_engine("jnp") == "jnp"
    assert backend.use_kernel()
    assert backend.auto_device_threshold() == backend.AUTO_DEVICE_THRESHOLD


def test_kernel_on_cpu_raises():
    with pytest.raises(RuntimeError, match="GPU only"):
        backend.require_gpu("the kernel")
    with pytest.raises(RuntimeError, match="GPU only"):
        backend.use_kernel("pallas")


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="unknown engine"):
        backend.hash_engine("mxu")
    with pytest.raises(ValueError, match="unknown engine"):
        backend.use_kernel("mxu", interpret=True)


def test_interpret_selects_kernel_body():
    assert backend.use_kernel("auto", interpret=True)
    assert backend.use_kernel("pallas", interpret=True)
    assert not backend.use_kernel("jnp", interpret=True)


def test_facade_threshold_on_cpu():
    from nthash_tpu import api

    assert api._auto_device_threshold() == backend.AUTO_DEVICE_THRESHOLD_CPU


@pytest.mark.parametrize("interpret", [False, True], ids=["jnp", "kernel"])
def test_hash_windows_tm_matches_oracle(rng, interpret):
    codes = rng.integers(0, 5, size=(5, 30), dtype=np.uint8)
    hashes, valid = backend.hash_windows_tm(jnp.asarray(codes), 7, 2,
                                            interpret=interpret)
    assert np.asarray(valid).shape == (24, 5)
    for b in range(5):
        _, _, ext, v = oracle.hash_all_windows(codes[b], 7, 2)
        assert np.array_equal(np.asarray(valid)[:, b], v)
        for i in range(2):
            assert np.array_equal(hashes[i].to_np()[:, b][v], ext[v, i])


@pytest.mark.parametrize("interpret", [False, True], ids=["jnp", "kernel"])
def test_bucket_rows_match_oracle(rng, interpret):
    codes = rng.integers(0, 5, size=(6, 20), dtype=np.uint8)
    wl = 9
    rows = backend.bucket_rows(jnp.asarray(codes), 5, 3, wl,
                               interpret=interpret)
    assert len(rows) == 3
    for b in range(6):
        _, _, ext, v = oracle.hash_all_windows(codes[b], 5, 3)
        for r in range(3):
            want = np.where(v, ext[:, r] & np.uint64((1 << wl) - 1), 1 << wl)
            assert np.array_equal(np.asarray(rows[r])[:, b], want)
    # any rows past the batch (kernel padding) hold only the sentinel
    assert np.all(np.asarray(rows[0])[:, 6:] == 1 << wl)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert backend.compile_cache_dir() == str(tmp_path)
    assert backend.enable_compile_cache() == str(tmp_path)
    # the variable is JAX's own: nothing else is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = backend.compile_cache_dir()
    assert first == str(REPO / ".jax_cache")
    assert backend.compile_cache_dir() == first  # stable across calls


def test_compile_cache_outside_checkout_leaves_jax_default(monkeypatch,
                                                          tmp_path):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    pkg = tmp_path / "site-packages" / "nthash_tpu"
    pkg.mkdir(parents=True)
    monkeypatch.setattr(backend, "__file__", str(pkg / "backend.py"))
    before = jax.config.jax_compilation_cache_dir
    assert backend.compile_cache_dir() is None
    assert backend.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_jax_cache_is_gitignored():
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


def test_native_build_key_names_host_and_compiler():
    import platform

    if not native_loader.available():
        pytest.skip("no C++ toolchain")
    key = native_loader.build_key()
    assert key.startswith(f"{platform.node() or 'host'}-{platform.machine()}-")
    assert key == native_loader.build_key()
    lib = native_loader.library_path()
    assert lib is not None and lib.parent.name == key
    assert lib.is_relative_to(REPO / "nthash_tpu" / "io" / "native" / "build")
