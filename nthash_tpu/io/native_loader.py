"""ctypes bindings for the native C++ FASTX parser/encoder.

The shared library builds lazily on first use (``g++ -O3 -march=native``)
into ``native/build/<key>/``, where the key names the host, its CPU
architecture, the compiler's version and the source's content. A library
built on one machine is never loaded on another CPU, and editing the
source or changing compilers rebuilds it. The build directory is
gitignored. Callers that can't build (no toolchain) fall back to the
numpy loader in io/fasta.py transparently via ``available()``;
:func:`library_path` says which parser a run used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "native" / "fastx.cpp"
_BUILD = Path(__file__).parent / "native" / "build"
_CXX = "g++"

_lib = None
_lib_path: Path | None = None
_build_error: str | None = None


def _cpu_features() -> bytes:
    """The first CPU's model and flags (what ``-march=native`` reads)."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return platform.processor().encode()
    keep = [ln for ln in text.split("\n\n")[0].splitlines()
            if ln.startswith(("model name", "flags", "Features"))]
    return "\n".join(keep).encode()


def build_key() -> str:
    """Host name, machine and a digest of (CPU features, compiler
    version, source)."""
    version = subprocess.run(
        [_CXX, "--version"], check=True, capture_output=True, text=True,
    ).stdout
    digest = hashlib.sha256(
        _cpu_features() + version.encode() + _SRC.read_bytes()
    ).hexdigest()[:16]
    return f"{platform.node() or 'host'}-{platform.machine()}-{digest}"


def _load():
    global _lib, _lib_path, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    try:
        lib_path = _BUILD / build_key() / "libfastx.so"
        if not lib_path.exists():
            lib_path.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(
                [_CXX, "-O3", "-march=native", "-shared", "-fPIC",
                 "-std=c++17", str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True, text=True,
            )
            # atomic rename: a concurrent process never loads a
            # half-written library
            tmp.replace(lib_path)
        lib = ctypes.CDLL(str(lib_path))
        lib.nthash_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p]
        lib.nthash_parser_open.restype = ctypes.c_void_p
        lib.nthash_parser_open.argtypes = [ctypes.c_char_p]
        lib.nthash_parser_open_range.restype = ctypes.c_void_p
        lib.nthash_parser_open_range.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.nthash_parser_tell.restype = ctypes.c_int64
        lib.nthash_parser_tell.argtypes = [ctypes.c_void_p]
        lib.nthash_parser_close.argtypes = [ctypes.c_void_p]
        lib.nthash_parser_next_batch.restype = ctypes.c_int64
        lib.nthash_parser_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.nthash_parser_error.restype = ctypes.c_char_p
        lib.nthash_parser_error.argtypes = [ctypes.c_void_p]
        _lib, _lib_path = lib, lib_path
    except (subprocess.CalledProcessError, OSError) as e:
        _build_error = getattr(e, "stderr", None) or str(e)
    return _lib


def available() -> bool:
    return _load() is not None


def library_path() -> Path | None:
    """The native library this process loaded, or None (numpy parser)."""
    _load()
    return _lib_path


def encode(seq: bytes) -> np.ndarray:
    """ASCII bytes -> uint8 base codes via the native encoder."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_error}")
    out = np.empty(len(seq), dtype=np.uint8)
    lib.nthash_encode(seq, len(seq), out.ctypes.data_as(ctypes.c_void_p))
    return out


def sniff_format(path) -> int:
    """1 = FASTA ('>'), 2 = FASTQ ('@') from the file's first byte —
    byte-range shards need it passed in (they can't see the head)."""
    with open(path, "rb") as f:
        first = f.read(1)
    if first == b">":
        return 1
    if first == b"@":
        return 2
    raise ValueError(f"{path}: not FASTA/FASTQ (first byte {first!r})")


class NativeFastxParser:
    """Streaming [B, L] code batches from a FASTA/FASTQ file (uncompressed).

    >>> with NativeFastxParser(path) as p:
    ...     for codes, lengths in p.batches(65536, 150):
    ...         ...

    ``start``/``end`` open a byte-range shard: exactly the records whose
    header byte lies in [start, end) are parsed (resyncing to the next
    record boundary after ``start``), so N shards covering the file
    partition its records — the basis of the multi-thread parallel parse
    (ctypes releases the GIL during the C calls, so shard threads truly
    overlap). ``fmt`` (from :func:`sniff_format`) is required when
    ``start > 0``.
    """

    def __init__(self, path, start: int = 0, end: int | None = None,
                 fmt: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self._lib = lib
        if start > 0 and fmt == 0:
            raise ValueError("byte-range shards need fmt (sniff_format)")
        if start == 0 and end is None and fmt == 0:
            self._h = lib.nthash_parser_open(str(path).encode())
        else:
            self._h = lib.nthash_parser_open_range(
                str(path).encode(), start,
                (1 << 62) if end is None else end, fmt,
            )
        if not self._h:
            raise FileNotFoundError(path)

    def tell(self) -> int:
        """Byte offset just past the last parsed record (the next record's
        header offset) — persist it to make stream resume an O(1) seek."""
        return int(self._lib.nthash_parser_tell(self._h))

    def close(self):
        if self._h:
            self._lib.nthash_parser_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def next_batch(self, max_reads: int, row_len: int):
        """Returns (codes [n, row_len] uint8, lengths [n] int64) or None at EOF."""
        codes = np.empty((max_reads, row_len), dtype=np.uint8)
        lengths = np.empty(max_reads, dtype=np.int64)
        n = self._lib.nthash_parser_next_batch(
            self._h, max_reads, row_len,
            codes.ctypes.data_as(ctypes.c_void_p),
            lengths.ctypes.data_as(ctypes.c_void_p),
        )
        if n < 0:
            raise ValueError(
                self._lib.nthash_parser_error(self._h).decode())
        if n == 0:
            return None
        return codes[:n], lengths[:n]

    def next_batch_into(self, out: np.ndarray) -> tuple[int, int]:
        """Fill rows of a preallocated [max_reads, row_len] uint8 array;
        returns (number of reads produced — 0 at EOF, max true read length
        in the batch). Zero-copy row writes — the streaming front-end's
        hot path (io/stream.py). Reads longer than row_len are truncated
        in ``out``; the caller detects that from the returned max length
        (io/stream.py raises unless truncation was opted into)."""
        max_reads, row_len = out.shape
        lengths = np.empty(max_reads, dtype=np.int64)
        n = self._lib.nthash_parser_next_batch(
            self._h, max_reads, row_len,
            out.ctypes.data_as(ctypes.c_void_p),
            lengths.ctypes.data_as(ctypes.c_void_p),
        )
        if n < 0:
            raise ValueError(self._lib.nthash_parser_error(self._h).decode())
        return int(n), int(lengths[:n].max()) if n else 0

    def batches(self, max_reads: int, row_len: int):
        while True:
            b = self.next_batch(max_reads, row_len)
            if b is None:
                return
            yield b
