"""ctypes bindings of the port's native IO library (src/commet_io.cpp).

The library is built at first use with g++ from the port's own source into
``commet_tpu_torch/_build/``, under a name keyed by the source's hash (as
``core/_cuda.py`` builds the CUDA sources), and loaded with ctypes. A failed
build raises with the compiler's message: nothing falls back to a Python
parse. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "src", "commet_io.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-Wall", "-fPIC", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib = None

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)


def _build() -> str:
    """Compile the source into a content-addressed shared library."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"libcommet_io_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS,
                               "-o", tmp, SOURCE, "-lz"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def load() -> ctypes.CDLL:
    """The built library (built on first call)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        lib.cio_parse.restype = ctypes.c_void_p
        lib.cio_parse.argtypes = [ctypes.c_char_p]
        for name, res in (("cio_n_reads", ctypes.c_int64),
                          ("cio_total_bases", ctypes.c_int64),
                          ("cio_format", ctypes.c_int),
                          ("cio_gzipped", ctypes.c_int)):
            getattr(lib, name).restype = res
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        for name, typ in (("cio_codes", ctypes.c_uint8),
                          ("cio_offsets", ctypes.c_int64),
                          ("cio_lengths", ctypes.c_int32),
                          ("cio_class_counts", ctypes.c_int64)):
            getattr(lib, name).restype = ctypes.POINTER(typ)
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.cio_free.argtypes = [ctypes.c_void_p]
        lib.cio_gather_packed.restype = ctypes.c_int
        lib.cio_gather_packed.argtypes = [_U8P, _I64P, _I32P, _I64P,
                                          ctypes.c_int64, ctypes.c_int64,
                                          _U32P, _U32P, _I32P]
        lib.cio_count_kmers.argtypes = [_U8P, _I64P, _I32P, _I64P,
                                        ctypes.c_int64, ctypes.c_int, _I64P]
        _lib = lib
        return lib


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def parse_file(path: str) -> dict:
    """Parse and encode a read file. Returns copies of codes / offsets /
    lengths / class_counts plus the format and whether it was gzipped."""
    lib = load()
    h = lib.cio_parse(path.encode())
    if not h:
        raise ValueError(f"Unknown format or unreadable file: {path}")
    try:
        n = lib.cio_n_reads(h)
        total = lib.cio_total_bases(h)
        codes = (np.ctypeslib.as_array(lib.cio_codes(h), shape=(total,))
                 .copy() if total else np.zeros(0, dtype=np.uint8))
        offsets = np.ctypeslib.as_array(lib.cio_offsets(h),
                                        shape=(n + 1,)).copy()
        lengths = (np.ctypeslib.as_array(lib.cio_lengths(h), shape=(n,))
                   .copy() if n else np.zeros(0, dtype=np.int32))
        counts = (np.ctypeslib.as_array(lib.cio_class_counts(h),
                                        shape=(n, 5)).copy()
                  if n else np.zeros((0, 5), dtype=np.int64))
        return {
            "n_reads": int(n),
            "codes": codes,
            "offsets": offsets,
            "lengths": lengths,
            "class_counts": counts,
            "format": "fasta" if lib.cio_format(h) == 1 else "fastq",
            "gzipped": bool(lib.cio_gzipped(h)),
        }
    finally:
        lib.cio_free(h)


def count_kmers(codes: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
                idx: np.ndarray, k: int) -> np.ndarray:
    """Complete windows of each read ``idx`` (partition cursor arithmetic,
    reference index_reads.h:55-58)."""
    lib = load()
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    out = np.zeros(len(idx), dtype=np.int64)
    if len(idx):
        lib.cio_count_kmers(_ptr(codes, ctypes.c_uint8),
                            _ptr(offsets, ctypes.c_int64),
                            _ptr(lengths, ctypes.c_int32),
                            _ptr(idx, ctypes.c_int64), len(idx), k,
                            _ptr(out, ctypes.c_int64))
    return out


def gather_packed(codes: np.ndarray, offsets: np.ndarray,
                  lengths: np.ndarray, idx: np.ndarray, lpad: int):
    """Gather + pack reads ``idx`` into the device wire format. Returns
    (codes2 [n, ceil(lpad/16)] uint32, valid [n, ceil(lpad/32)] uint32,
    lens [n] int32, dirty): dirty when some read holds an internal invalid
    base (the batch is not clean)."""
    lib = load()
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    n = len(idx)
    c2 = np.zeros((n, -(-lpad // 16)), dtype=np.uint32)
    vd = np.zeros((n, -(-lpad // 32)), dtype=np.uint32)
    ln = np.zeros(n, dtype=np.int32)
    dirty = lib.cio_gather_packed(
        _ptr(codes, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
        _ptr(lengths, ctypes.c_int32), _ptr(idx, ctypes.c_int64), n, lpad,
        _ptr(c2, ctypes.c_uint32), _ptr(vd, ctypes.c_uint32),
        _ptr(ln, ctypes.c_int32))
    return c2, vd, ln, bool(dirty)
