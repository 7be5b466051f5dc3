"""Build + ctypes binding of the host exact-kNN library (native/src).

The C++ KdTree (src/kdtree.h) and its kNN-only C API (src/knn_capi.cc) are
compiled with g++ at FIRST USE, never at import, into the ignored
`_build/` of the package, under a name keyed on a hash of the sources and
flags: an edit rebuilds, and an existing build is reused. Several
processes may build at once (parallel test workers): each compiles into
its own temporary file and `os.replace`s it into place, so a reader only
ever sees a whole library.

Flags: no -march=native and -ffp-contract=off, so the squared distances
are the same on every host (no contracted multiply-adds).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fopenmp", "-fPIC", "-shared",
             "-ffp-contract=off"]

_lib = None


def _sources() -> list[Path]:
    return sorted(_SRC.glob("*.cc"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources() + sorted(_SRC.glob("*.h")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgsplatloc_knn-{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the library unless an up-to-date build exists; returns its
    path. Raises RuntimeError when the compiler is missing or fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, f"-I{_SRC}", *map(str, _sources()), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        os.unlink(tmp)
        raise RuntimeError(f"exact-kNN library: cannot run g++: {exc}") from exc
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"exact-kNN library build failed ({' '.join(cmd)}):\n"
            f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        c_dp = ctypes.POINTER(ctypes.c_double)
        lib.gs_kdtree_build.restype = ctypes.c_void_p
        lib.gs_kdtree_build.argtypes = [c_dp, ctypes.c_int64]
        lib.gs_kdtree_free.restype = None
        lib.gs_kdtree_free.argtypes = [ctypes.c_void_p]
        lib.gs_kdtree_batch_knn.restype = None
        lib.gs_kdtree_batch_knn.argtypes = [
            ctypes.c_void_p, c_dp, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), c_dp,
        ]
        _lib = lib
    return _lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def knn(points, queries, k: int, num_threads: int = 8):
    """Exact k nearest tree points of every query. points (N, 3) and
    queries (Q, 3) array-likes, taken as float64. Returns (indices (Q, k)
    int32, SQUARED distances (Q, k) float64), ascending; a query that is a
    tree point finds itself first at distance 0."""
    lib = _load()
    pts = np.ascontiguousarray(points, np.float64)
    q = np.ascontiguousarray(queries, np.float64)
    if pts.ndim != 2 or pts.shape[1] != 3 or q.ndim != 2 or q.shape[1] != 3:
        raise ValueError("points and queries must be (N, 3)")
    idx = np.empty((q.shape[0], k), np.int32)
    d2 = np.empty((q.shape[0], k), np.float64)
    handle = lib.gs_kdtree_build(_dptr(pts), pts.shape[0])
    try:
        lib.gs_kdtree_batch_knn(
            handle, _dptr(q), q.shape[0], k, num_threads,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _dptr(d2))
    finally:
        lib.gs_kdtree_free(handle)
    return idx, d2
