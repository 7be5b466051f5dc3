"""Rules of the port that a reader cannot see from one module: no import
of JAX or of the reference package, importable without CUDA, entry points
that refuse to run on the CPU by themselves, a config equal to the
reference's field for field, and launch counters that count launches."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import gsplatloc_tpu_torch
from gsplatloc_tpu.opt.tracking import TrackingConfig as JConfig
from gsplatloc_tpu_torch import kernels
from gsplatloc_tpu_torch.opt.tracking import TrackingConfig

torch.set_num_threads(1)  # see tests/torch_port_helpers.py

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "gsplatloc_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "gsplatloc_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_neither_jax_nor_the_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"
    text = path.read_text()
    assert "import_module" not in text and "__import__" not in text


def test_package_layout_mirrors_the_reference():
    for rel in ("ops/lie.py", "ops/camera.py", "ops/fused_tracking.py",
                "ops/fused_subtile.py", "ops/kcover.py", "ops/filters.py",
                "ops/projection.py", "ops/binning.py", "ops/sh.py",
                "ops/knn.py", "ops/pca.py", "models/pose.py",
                "models/gaussians.py", "opt/adam.py", "opt/tracking.py",
                "losses.py", "data/base.py", "data/synthetic.py",
                "data/datasets.py", "data/parser.py"):
        assert (PKG / rel).exists(), rel
        assert (ROOT / "gsplatloc_tpu" / rel).exists(), rel
    assert sorted(p.name for p in (PKG / "csrc").glob("*.cu")) == [
        "kcover_select.cu", "kcover_step.cu", "subtile_fwd.cu"]
    assert (PKG / "csrc" / "project.cuh").exists()


def test_import_needs_no_cuda_and_builds_nothing():
    """A fresh interpreter with no visible GPU imports the whole package,
    sets the TF32 flags, and neither builds nor loads a kernel library."""
    code = (
        "import sys, torch, pathlib\n"
        "import gsplatloc_tpu_torch as g\n"
        "from gsplatloc_tpu_torch import kernels, convert, losses\n"
        "from gsplatloc_tpu_torch.ops import kcover, fused_subtile, knn, pca\n"
        "from gsplatloc_tpu_torch.opt import tracking\n"
        "from gsplatloc_tpu_torch.data import parser\n"
        "assert not torch.cuda.is_available()\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
        "assert kernels._lib is None\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or "
        "m.startswith('gsplatloc_tpu.') or m == 'gsplatloc_tpu' "
        "for m in sys.modules)\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(ROOT)},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert not (PKG / "_build").exists() or not any(
        (PKG / "_build").glob("*.so"))


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert gsplatloc_tpu_torch.__version__


def _entry_points():
    from gsplatloc_tpu_torch.data import parser
    from gsplatloc_tpu_torch.models.gaussians import scene_from_point_cloud
    from gsplatloc_tpu_torch.opt.tracking import optimize_pose

    pts = np.random.default_rng(0).random((8, 3)).astype(np.float32)
    eye = np.eye(4, dtype=np.float32)
    K = np.eye(3, dtype=np.float32)
    img = np.zeros((2, 2, 3), np.float32)
    dep = np.ones((2, 2), np.float32)
    scene = scene_from_point_cloud(pts, pts, device="cpu")
    return {
        "scene_from_point_cloud": lambda: scene_from_point_cloud(pts, pts),
        "render_depth_gt": lambda: parser.render_depth_gt(
            pts, pts, K, eye, 2, 2),
        "_assemble_pair": lambda: parser._assemble_pair(
            img, dep, eye, img, dep, eye, K, 2, 2),
        "Parser": lambda: parser.Parser("Synthetic", "x", n_frames=3,
                                        height=8, width=8),
        "optimize_pose": lambda: optimize_pose(scene, eye, dep, K, 2, 2),
    }


@pytest.mark.parametrize("name", ["scene_from_point_cloud", "render_depth_gt",
                                  "_assemble_pair", "Parser",
                                  "optimize_pose"])
def test_entry_point_with_default_device_raises_without_a_card(name):
    """The default device is the card; with none present an entry point
    raises — it never carries on on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        _entry_points()[name]()


def test_tracking_config_defaults_equal_the_reference():
    assert TrackingConfig._fields == JConfig._fields
    assert TrackingConfig() == tuple(JConfig())
    assert TrackingConfig._field_defaults == JConfig._field_defaults
    assert (TrackingConfig().kcover, TrackingConfig().subtile) == (16, True)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    from gsplatloc_tpu_torch.ops import fused_subtile as fs
    from gsplatloc_tpu_torch.ops import kcover as kc
    from gsplatloc_tpu_torch.ops.fused_tracking import cam_vector

    kernels.reset_launch_counts()
    n_ty = n_tx = 1
    m_out = 8 * 256
    cam = cam_vector(torch.eye(4), torch.eye(3), 128, 16)
    slot = torch.zeros((8, 8192))
    meta = torch.zeros((10,), dtype=torch.int32)
    p8 = fs.project8(slot, cam, 1e-2, 1e10)
    fs.subtile_fwd(p8, meta, n_ty, n_tx)
    kb = kc.select_kcover_records(slot, meta, cam, n_ty, n_tx, 8, 1e-2, 1e10)
    kc.kcover_step_fwd(kb, cam, n_ty, n_tx, 1e-2, 1e10)
    kc.kcover_step_bwd(kb, cam, n_ty, n_tx, 1e-2, 1e10,
                       torch.zeros(m_out), torch.zeros(m_out))
    counts = kernels.launch_counts()
    assert set(counts) == {"kcover_step_fwd", "kcover_step_bwd",
                           "kcover_select_records", "project8",
                           "subtile_fwd"}
    assert all(v == 0 for v in counts.values()), counts
    assert kernels._lib is None  # nothing was built or loaded


def test_every_kernel_entry_point_has_a_signature_and_a_source():
    text = "".join(p.read_text() for p in kernels.sources())
    for name, argtypes in kernels._SIGNATURES.items():
        assert f'extern "C" int {name}(' in text, name
        assert argtypes and all(a is not None for a in argtypes)
    assert len(kernels.source_hash()) == 16
    assert "-fmad=false" in kernels.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        kernels.require(torch.zeros(4, dtype=torch.float64), "x")
    with pytest.raises(ValueError):
        kernels.require(torch.zeros(4, 4).T[1:], "x")
    with pytest.raises(ValueError):
        kernels.require(torch.zeros(4), "x", shape=(5,))
    with pytest.raises(RuntimeError):
        kernels.check(1, "some_kernel")
    kernels.check(0, "some_kernel")
