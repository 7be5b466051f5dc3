"""Build + load of the hand-written CUDA kernels (csrc/*.cu).

One nvcc per source (all started together) compiles csrc/*.cu for sm_90a
into object files, one link makes `_build/libgsplatloc_kernels.so`, and
ctypes loads it. The build runs at FIRST USE of a kernel, never at
import, and is keyed on a hash of the sources: an edit rebuilds. The
entry points are plain C functions taking device pointers, ints, floats
and the CUDA stream; each returns cudaGetLastError() and `check` raises
when that is not 0. Kernels allocate nothing and never synchronise.

-fmad=false: alpha >= 1/255, T > 1e-4 and sigma >= -1e-2 are knife-edge
gates — a contracted multiply-add that the plain PyTorch version does
not make flips whole splats at footprint edges. With contraction off and
the plain versions' operation order kept in csrc/project.cuh, the walk
kernels reproduce their plain versions bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libgsplatloc_kernels.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry point -> argtypes (every pointer and the stream are c_void_p)
_SIGNATURES = {
    "gsl_kcover_step_fwd": [_P, _P, _P, _I, _L, _I, _F, _F, _F, _P],
    "gsl_kcover_step_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _F, _F, _F,
                            _I, _P],
    "gsl_kcover_select_records": [_P, _P, _P, _P, _I, _L, _L, _I, _I, _F, _F, _P],
    "gsl_kcover_select": [_P, _P, _P, _I, _L, _L, _I, _I, _P],
    "gsl_project8": [_P, _P, _P, _L, _F, _F, _P],
    "gsl_subtile_fwd": [_P, _P, _P, _P, _I, _L, _L, _I, _P],
    "gsl_subtile_bwd": [_P, _P, _P, _P, _P, _I, _L, _L, _I, _P],
    "gsl_subtile_chain": [_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _P],
    "gsl_rasterize_fwd": [_P, _P, _P, _P, _I, _I, _L, _P],
    "gsl_rasterize_bwd": [_P, _P, _P, _P, _P, _I, _I, _L, _P],
    "gsl_fused_fwd": [_P, _P, _P, _P, _P, _I, _I, _L, _F, _F, _P],
    "gsl_fused_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _L, _F, _F, _P],
    "gsl_fused_probe": [_P, _P, _P, _P, _P, _I, _I, _L, _F, _F, _P],
}

REDUCE_THREADS = 256  # block size of the pose-partial reductions (reduce.cuh)
CHAIN_BLOCKS = 264  # subtile_chain's fixed grid (csrc/subtile_bwd.cu)

_lib = None
build_seconds = None  # wall time of the build this process made (None: reused)


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of gsplatloc_tpu_torch are "
        "compiled from csrc/ at first use and need the CUDA toolkit"
    )


def build_library(verbose: bool = False) -> Path:
    """Compile csrc/*.cu (in parallel) and link the shared library, unless
    an up-to-date build is already in _build/. Returns the library path."""
    global build_seconds
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".hash")
    want = source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text() == want:
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in sources():
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC_DIR),
               "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, objs, failed = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(log)[-6000:])
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout[-6000:]}")
    stamp.write_text(want)
    build_seconds = time.perf_counter() - t0
    if verbose:
        print("\n".join(log))
    return lib


def load():
    """The ctypes library with argtypes set (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_ptr() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


def require(t, name: str, shape=None, dtype=None, device=None) -> None:
    """Raise on a tensor the kernels do not take (wrong device, dtype,
    shape, or non-contiguous)."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")


def require_cam(cam, device) -> None:
    """The cam vector the kernels read: >= 18 contiguous f32 scalars
    [fx, fy, cx, cy, R(9), t(3), W, H] on the kernel's device."""
    require(cam, "cam", (cam.shape[0],), device=device)
    if cam.shape[0] < 18:
        raise ValueError("cam must hold at least 18 scalars")


def _wrappers():
    from ..ops import fused_subtile, fused_tracking, kcover, rasterize_tiles

    return {
        "kcover_step_fwd": kcover.kcover_step_fwd,
        "kcover_step_bwd": kcover.kcover_step_bwd,
        "kcover_select_records": kcover.select_kcover_records,
        "kcover_select": kcover.select_kcover,
        "project8": fused_subtile.project8,
        "subtile_fwd": fused_subtile.subtile_fwd,
        "subtile_bwd": fused_subtile.subtile_bwd,
        "subtile_chain": fused_subtile.subtile_chain,
        "rasterize_fwd": rasterize_tiles.rasterize_fwd,
        "rasterize_bwd": rasterize_tiles.rasterize_bwd,
        "fused_fwd": fused_tracking.fused_fwd,
        "fused_bwd": fused_tracking.fused_bwd,
        "fused_probe": fused_tracking.fused_probe,
    }


def launch_counts() -> dict:
    """Kernel name -> launches so far (each wrapper bumps its own plain int
    where it launches its kernel, and nowhere else)."""
    return {k: w.launches for k, w in _wrappers().items()}


def reset_launch_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0
