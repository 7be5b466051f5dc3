"""The port's exact kNN (the host C++ KdTree of gsplatloc_tpu_torch/native)
against scipy's cKDTree, which belongs to neither package, and its use in
the scene build and the parser's per-frame cache. The reference's own
exact kNN is never called here: it rebuilds a tracked library."""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from gsplatloc_tpu.data.synthetic import box_room_frame
from gsplatloc_tpu.models import gaussians as jgauss
from gsplatloc_tpu_torch import native
from gsplatloc_tpu_torch.data import parser as tparser
from gsplatloc_tpu_torch.models import gaussians as tgauss
from gsplatloc_tpu_torch.ops import knn as tknn
from torch_port_helpers import intrinsics, to_np


def _clouds():
    rng = np.random.default_rng(0)
    K = intrinsics(24, 32)
    _rgb, depth = box_room_frame(np.eye(4), K, 24, 32, clutter=4)
    v, u = np.mgrid[0:24, 0:32].astype(np.float32)
    grid = np.stack([(u - K[0, 2]) / K[0, 0] * depth,
                     (v - K[1, 2]) / K[1, 1] * depth, depth], -1)
    return {
        "gaussian": rng.normal(size=(3000, 3)),
        "depth_grid": grid.reshape(-1, 3).astype(np.float64),
        # many exact ties: an integer lattice
        "lattice": np.stack(np.meshgrid(*[np.arange(9.0)] * 3),
                            -1).reshape(-1, 3),
    }


@pytest.mark.parametrize("name", ["gaussian", "depth_grid", "lattice"])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_exact_knn_matches_ckdtree(name, k):
    """Squared distances within 1e-12 relative of cKDTree's (both are exact
    in float64; ties may order their indices differently)."""
    pts = _clouds()[name]
    idx, d2 = native.knn(pts, pts, k, num_threads=2)
    dd, ii = cKDTree(pts).query(pts, k=k)
    ref = (dd ** 2).reshape(d2.shape)
    assert idx.shape == d2.shape == (pts.shape[0], k)
    np.testing.assert_allclose(d2, ref, rtol=1e-12, atol=0)
    assert (d2[:, 0] == 0).all()
    # every index is at its reported distance
    recomputed = np.sum((pts[:, None, :] - pts[idx]) ** 2, axis=-1)
    np.testing.assert_array_equal(recomputed, d2)


def test_queries_other_than_the_tree_points():
    rng = np.random.default_rng(1)
    pts, q = rng.random((500, 3)), rng.random((40, 3))
    _idx, d2 = native.knn(pts, q, 3, num_threads=1)
    dd, _ii = cKDTree(pts).query(q, k=3)
    np.testing.assert_allclose(d2, dd ** 2, rtol=1e-12, atol=0)
    with pytest.raises(ValueError):
        native.knn(pts[:, :2], q, 3)


def test_exact_knn_sq_dists_is_float32_of_the_exact_distances():
    pts = _clouds()["depth_grid"].astype(np.float32)
    d2 = tknn.exact_knn_sq_dists(torch.as_tensor(pts), 5)
    dd, _ii = cKDTree(pts.astype(np.float64)).query(pts.astype(np.float64),
                                                    k=5)
    assert d2.dtype == torch.float32 and tuple(d2.shape) == (pts.shape[0], 5)
    np.testing.assert_array_equal(to_np(d2), (dd ** 2).astype(np.float32))


def test_thread_count_does_not_change_the_result():
    pts = _clouds()["gaussian"]
    one = native.knn(pts, pts, 5, num_threads=1)
    four = native.knn(pts, pts, 5, num_threads=4)
    np.testing.assert_array_equal(one[1], four[1])
    np.testing.assert_array_equal(one[0], four[0])


def test_scene_from_point_cloud_exact_matches_reference_on_the_same_dists():
    """knn_method='exact' in the port equals the reference's scene built
    from cKDTree's squared distances."""
    pts = _clouds()["depth_grid"].astype(np.float32)
    rgb = np.random.default_rng(2).random(pts.shape).astype(np.float32)
    dd, _ii = cKDTree(pts.astype(np.float64)).query(pts.astype(np.float64),
                                                    k=5)
    sj = jgauss.scene_from_point_cloud(
        jnp.asarray(pts), jnp.asarray(rgb),
        knn_sq_dists=jnp.asarray((dd ** 2).astype(np.float32)))
    st = tgauss.scene_from_point_cloud(pts, rgb, knn_method="exact",
                                       device="cpu")
    for f in sj._fields:
        np.testing.assert_allclose(to_np(getattr(st, f)),
                                   np.asarray(getattr(sj, f)), rtol=1e-6,
                                   atol=1e-9, err_msg=f)


def test_parser_exact_knn_cache_fills_once_per_frame(monkeypatch):
    """Parser(knn_method='exact') computes each frame's kNN once while it
    walks the pairs (a frame is pair i-1's src and pair i's tar), keeps the
    last three, and feeds the depth-target scene with them."""
    calls = []
    real = tknn.exact_knn_sq_dists

    def counting(points, k=5):
        calls.append(points.shape[0])
        return real(points, k)

    monkeypatch.setattr(tknn, "exact_knn_sq_dists", counting)
    p = tparser.Parser("Synthetic", "", knn_method="exact", device="cpu",
                       n_frames=5, height=16, width=24)
    for i in range(len(p)):
        p.knn_for_frame(i)
        data = p[i]
        assert bool(torch.isfinite(data.src_depth).all())
    assert len(calls) == 5 and set(calls) == {16 * 24}
    assert sorted(p._knn_cache) == [2, 3, 4]
    d2 = p.knn_for_frame(4)
    assert tuple(d2.shape) == (16 * 24, 5) and float(d2[:, 0].abs().max()) == 0
    assert len(calls) == 5
    assert tparser.Parser("Synthetic", "", device="cpu", n_frames=3,
                          height=8, width=8).knn_for_frame(0) is None


def test_concurrent_builds_leave_one_whole_library(tmp_path):
    """Several processes building at once (parallel test workers) each
    compile into a temporary file and rename it into place."""
    code = (
        "import sys; from pathlib import Path\n"
        "from gsplatloc_tpu_torch import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "import numpy as np\n"
        "i, d = native.knn(np.eye(3), np.eye(3), 2)\n"
        "print(d[0, 1])\n")
    root = pathlib.Path(__file__).resolve().parent.parent
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=str(root), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert all(float(o[0]) == 2.0 for o in outs)
    libs = list(tmp_path.glob("*.so"))
    assert len(libs) == 1 and libs[0].name.startswith("libgsplatloc_knn-")
    assert not [p for p in tmp_path.iterdir() if p not in libs]


def test_knn_leaves_torch_thread_count_alone():
    """The kNN's OpenMP threads come from its parallel region's clause: the
    OpenMP runtime is shared with torch in one process, and a global
    thread-count change would set torch's too (six test workers with eight
    threads each slow the suite thirtyfold)."""
    before = torch.get_num_threads()
    native.knn(_clouds()["gaussian"], _clouds()["gaussian"], 5,
               num_threads=8)
    assert torch.get_num_threads() == before
