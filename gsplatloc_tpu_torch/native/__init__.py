"""Build + ctypes binding of the host point-cloud library (native/src).

The C++ KdTree (src/kdtree.h) with its kNN C API (src/knn_capi.cc), and
the registration library of the classical baselines (src/registration.{h,
cc} with its C API src/icp_capi.cc: normals and covariances, voxel
downsampling, colour gradients, ICP / PLANE_ICP / GICP / colored ICP) are
compiled with g++ at FIRST USE, never at import, into the ignored
`_build/` of the package, under a name keyed on a hash of the sources and
flags: an edit rebuilds, and an existing build is reused. Several
processes may build at once (parallel test workers): each compiles into
its own temporary file and `os.replace`s it into place, so a reader only
ever sees a whole library.

Flags: no -march=native and -ffp-contract=off, so the squared distances
are the same on every host (no contracted multiply-adds).

The Python surface mirrors the reference's bindings
(`gsplatloc_tpu/native/__init__.py`, small_gicp's surface): `knn`,
`KdTree`, `voxel_downsample`, `align`, `estimate_color_gradients`,
`align_colored`, `PointCloud`.
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

REG_TYPES = {"ICP": 0, "PLANE_ICP": 1, "GICP": 2, "COLORED_ICP": 3}

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
        raise RuntimeError(f"native library: cannot run g++: {exc}") from exc
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"native library build failed ({' '.join(cmd)}):\n"
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
        c_ip = ctypes.POINTER(ctypes.c_int32)
        lib.gs_estimate_normals_covs.restype = None
        lib.gs_estimate_normals_covs.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, c_dp, c_dp,
        ]
        lib.gs_voxel_downsample.restype = ctypes.c_int64
        lib.gs_voxel_downsample.argtypes = [
            c_dp, ctypes.c_int64, ctypes.c_double, c_dp, ctypes.c_int64,
        ]
        lib.gs_register.restype = None
        lib.gs_register.argtypes = [
            ctypes.c_void_p, c_dp, ctypes.c_int64, c_dp, ctypes.c_int64,
            c_dp, c_dp, c_dp, ctypes.c_int32, c_dp, ctypes.c_double,
            ctypes.c_int32, ctypes.c_int32, c_dp, c_dp, c_ip, c_ip,
        ]
        lib.gs_estimate_color_gradients.restype = None
        lib.gs_estimate_color_gradients.argtypes = [
            ctypes.c_void_p, c_dp, c_dp, ctypes.c_int32, ctypes.c_int32, c_dp,
        ]
        lib.gs_register_colored.restype = None
        lib.gs_register_colored.argtypes = [
            ctypes.c_void_p, c_dp, ctypes.c_int64, c_dp, ctypes.c_int64,
            c_dp, c_dp, c_dp, c_dp, ctypes.c_double, c_dp, ctypes.c_double,
            ctypes.c_int32, ctypes.c_int32, c_dp, c_dp, c_ip, c_ip,
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


class KdTree:
    """KdTree over an (N, 3) float64 cloud (small_gicp.KdTree's surface)."""

    def __init__(self, points: np.ndarray, num_threads: int = 4):
        self._lib = _load()
        self.points = np.ascontiguousarray(points, np.float64)
        if self.points.ndim != 2 or self.points.shape[1] != 3:
            raise ValueError("points must be (N, 3)")
        self._handle = self._lib.gs_kdtree_build(_dptr(self.points),
                                                 self.points.shape[0])
        self.num_threads = num_threads

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.gs_kdtree_free(self._handle)
            self._handle = None

    def batch_knn_search(self, queries: np.ndarray, k: int,
                         num_threads: int | None = None):
        """-> (indices (Q, k) int32, SQUARED distances (Q, k) float64)."""
        q = np.ascontiguousarray(queries, np.float64)
        idx = np.empty((q.shape[0], k), np.int32)
        d2 = np.empty((q.shape[0], k), np.float64)
        self._lib.gs_kdtree_batch_knn(
            self._handle, _dptr(q), q.shape[0], k,
            num_threads or self.num_threads,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _dptr(d2))
        return idx, d2

    def estimate_normals_covariances(self, k: int = 20,
                                     num_threads: int | None = None):
        """-> (normals (N, 3), plane-regularized covariances (N, 3, 3)) from
        the PCA of each point's k nearest neighbours."""
        n = self.points.shape[0]
        normals = np.empty((n, 3), np.float64)
        covs = np.empty((n, 3, 3), np.float64)
        self._lib.gs_estimate_normals_covs(
            self._handle, k, num_threads or self.num_threads,
            _dptr(normals), _dptr(covs))
        return normals, covs


def voxel_downsample(points: np.ndarray, resolution: float) -> np.ndarray:
    """Voxel-grid downsampling to each voxel's centroid."""
    lib = _load()
    p = np.ascontiguousarray(points, np.float64)
    out = np.empty_like(p)
    m = lib.gs_voxel_downsample(_dptr(p), p.shape[0], resolution, _dptr(out),
                                p.shape[0])
    return out[:m].copy()


class RegistrationResult:
    def __init__(self, T, error, iterations, inliers):
        self.T_target_source = T
        self.error = error
        self.iterations = iterations
        self.inliers = inliers


def _opt_ptr(a):
    return None if a is None else _dptr(a)


def _init_T(init):
    return np.ascontiguousarray(np.eye(4) if init is None else init,
                                np.float64)


def _result(call, *args):
    """Run a registration entry point; its last four arguments are the
    outputs (T, error, iterations, inliers)."""
    out_T = np.empty((4, 4), np.float64)
    err, iters, inliers = ctypes.c_double(), ctypes.c_int32(), ctypes.c_int32()
    call(*args, _dptr(out_T), ctypes.byref(err), ctypes.byref(iters),
         ctypes.byref(inliers))
    return RegistrationResult(out_T, err.value, iters.value, inliers.value)


def align(
    target: np.ndarray,
    source: np.ndarray,
    target_tree: KdTree | None = None,
    init_T_target_source: np.ndarray | None = None,
    max_correspondence_distance: float = 0.1,
    registration_type: str = "GICP",
    num_threads: int = 4,
    max_iterations: int = 20,
    knn: int = 20,
    target_normals: np.ndarray | None = None,
    target_covs: np.ndarray | None = None,
    source_covs: np.ndarray | None = None,
) -> RegistrationResult:
    """Estimate T_target_source by Gauss-Newton ICP / PLANE_ICP / GICP
    (small_gicp.align's surface). Missing normals or covariances are
    estimated from the kNN PCA."""
    lib = _load()
    tgt = np.ascontiguousarray(target, np.float64)
    src = np.ascontiguousarray(source, np.float64)
    tree = target_tree or KdTree(tgt, num_threads)
    rtype = REG_TYPES[registration_type]
    if rtype == 1 and target_normals is None:
        target_normals, _ = tree.estimate_normals_covariances(knn, num_threads)
    if rtype == 2:
        if target_covs is None:
            _, target_covs = tree.estimate_normals_covariances(knn,
                                                               num_threads)
        if source_covs is None:
            _, source_covs = KdTree(src, num_threads) \
                .estimate_normals_covariances(knn, num_threads)
    tn, tc, sc = (None if a is None else np.ascontiguousarray(a, np.float64)
                  for a in (target_normals, target_covs, source_covs))
    init = _init_T(init_T_target_source)
    return _result(
        lib.gs_register, tree._handle, _dptr(tgt), tgt.shape[0], _dptr(src),
        src.shape[0], _opt_ptr(tn), _opt_ptr(tc), _opt_ptr(sc), rtype,
        _dptr(init), max_correspondence_distance, max_iterations, num_threads)


def estimate_color_gradients(tree: KdTree, colors: np.ndarray,
                             normals: np.ndarray, k: int = 20,
                             num_threads: int = 4) -> np.ndarray:
    """Per-point tangent-plane intensity gradients (colored ICP's
    precompute)."""
    lib = _load()
    grads = np.empty((tree.points.shape[0], 3), np.float64)
    c = np.ascontiguousarray(colors, np.float64)
    nr = np.ascontiguousarray(normals, np.float64)
    lib.gs_estimate_color_gradients(tree._handle, _dptr(c), _dptr(nr), k,
                                    num_threads, _dptr(grads))
    return grads


def align_colored(
    target: np.ndarray,
    source: np.ndarray,
    target_colors: np.ndarray,  # (nt,) intensity in [0,1]
    source_colors: np.ndarray,  # (ns,)
    target_tree: KdTree | None = None,
    init_T_target_source: np.ndarray | None = None,
    max_correspondence_distance: float = 0.1,
    lambda_geometric: float = 0.968,
    num_threads: int = 4,
    max_iterations: int = 30,
    knn: int = 20,
) -> RegistrationResult:
    """Colored ICP (Park et al.; Open3D's registration_colored_icp):
    point-to-plane plus a tangent-plane colour term."""
    lib = _load()
    tgt = np.ascontiguousarray(target, np.float64)
    src = np.ascontiguousarray(source, np.float64)
    tree = target_tree or KdTree(tgt, num_threads)
    normals, _ = tree.estimate_normals_covariances(knn, num_threads)
    grads = estimate_color_gradients(tree, target_colors, normals, knn,
                                     num_threads)
    tc = np.ascontiguousarray(target_colors, np.float64)
    sc = np.ascontiguousarray(source_colors, np.float64)
    init = _init_T(init_T_target_source)
    return _result(
        lib.gs_register_colored, tree._handle, _dptr(tgt), tgt.shape[0],
        _dptr(src), src.shape[0], _dptr(normals), _dptr(tc), _dptr(grads),
        _dptr(sc), lambda_geometric, _dptr(init),
        max_correspondence_distance, max_iterations, num_threads)


class PointCloud:
    """Points + KdTree + normals/covariances (the reference's PointClouds
    wrapper over small_gicp: preprocess(knn) builds the tree and estimates
    normals and covariances)."""

    def __init__(self, points: np.ndarray, num_threads: int = 4):
        self.points = np.ascontiguousarray(points[:, :3], np.float64)
        self.num_threads = num_threads
        self.tree: KdTree | None = None
        self.normals: np.ndarray | None = None
        self.covs: np.ndarray | None = None

    def __len__(self):
        return self.points.shape[0]

    def preprocess(self, knn: int = 20):
        """Build the KdTree and estimate normals and covariances."""
        self.tree = KdTree(self.points, self.num_threads)
        self.normals, self.covs = self.tree.estimate_normals_covariances(
            knn, self.num_threads)
        return self

    def downsample(self, resolution: float) -> "PointCloud":
        return PointCloud(voxel_downsample(self.points, resolution),
                          self.num_threads)
