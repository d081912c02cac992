"""Build and bind the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into a
plain shared library at first use (one build per source content, cached in
``commet_tpu_torch/_build/``) and loaded with ``ctypes``: the C functions take
raw device pointers and the CUDA stream, and return ``cudaGetLastError()``.
Nothing here runs at import time; a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "core", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# a packed read batch in planes.cu: codes2, nw2, aux, nwv, clean, b, length
_BATCH = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
          ctypes.c_int, ctypes.c_int64, ctypes.c_int]

# C signatures of the exported functions, per source file
_SIGNATURES = {
    "join": {"commet_join": [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_int64, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
             "commet_join_multi": [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p]},
    "planes": {"commet_build_planes": [ctypes.c_void_p, ctypes.c_int64,
                                       *_BATCH, ctypes.c_int,
                                       ctypes.c_void_p],
               "commet_probe_planes": [ctypes.c_void_p, ctypes.c_int64,
                                       *_BATCH, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_void_p],
               "commet_probe_planes_multi": [ctypes.c_void_p, ctypes.c_int64,
                                             ctypes.c_int64, *_BATCH,
                                             ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_void_p],
               "commet_build_planes_range": [ctypes.c_void_p, ctypes.c_int64,
                                             ctypes.c_int64, *_BATCH,
                                             ctypes.c_int, ctypes.c_void_p],
               "commet_probe_planes_part_a": [
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, *_BATCH,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p],
               "commet_probe_planes_part": [
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, *_BATCH,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p],
               "commet_bulk_hist": [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, *_BATCH, ctypes.c_int,
                                    ctypes.c_void_p],
               "commet_bulk_scatter": [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int, ctypes.c_int, *_BATCH,
                                       ctypes.c_int, ctypes.c_void_p],
               "commet_bulk_refine": [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_void_p],
               "commet_bulk_apply": [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p],
               # measurement only (chip_smoke.py): the level-1 roll alone
               # and 4-byte stores in runs
               "commet_bulk_decode": [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, *_BATCH, ctypes.c_int,
                                      ctypes.c_void_p],
               "commet_store_runs": [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_void_p]},
    "filter": {"commet_class_counts": [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_void_p]},
}

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from source")


def _build(name: str) -> str:
    """Compile csrc/<name>.cu into a content-addressed shared library."""
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu (built on first call)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_build(name))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).restype = ctypes.c_int  # cudaError_t
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib


def load_all() -> dict:
    """Every csrc library, built at once (one nvcc per source, started
    together) and loaded: {name: library}."""
    names = list(_SIGNATURES)
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        list(ex.map(_build, names))
    return {name: load(name) for name in names}
