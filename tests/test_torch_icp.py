"""The port's classical baselines: its copy of the native registration
library (native/src/registration.{h,cc}, icp_capi.cc), the cases of
tests/test_native_icp.py through it, a run that repeats bit for bit, the
port's ICPExperiment against the reference's, the sweep's resume ledger,
`cli icp`, and the baselines' reference records.

The reference's ICPExperiment runs on its own C++ sources, compiled here
into a temporary directory with its own flags: its `build_library` is
never called (it may rewrite the library the repository tracks).
Tolerances: per pair eT within 1e-6 m and eR within 1e-4 deg of the
reference's (the two libraries differ in their compile flags and, at 4
threads, in the order the partial sums are joined)."""

import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import gsplatloc_tpu.native as jnative
from gsplatloc_tpu.data.datasets import SyntheticBoxRoom as JSyntheticBoxRoom
from gsplatloc_tpu.tracking import icp as jicp
from gsplatloc_tpu_torch import cli, native
from gsplatloc_tpu_torch.data.datasets import SyntheticBoxRoom
from gsplatloc_tpu_torch.eval import fixture_compare
from gsplatloc_tpu_torch.tracking import icp
from torch_port_helpers import to_np  # noqa: F401  (pins torch's threads)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"


def _surface_cloud(n_side=50, noise=0.002, seed=1):
    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.linspace(-1, 1, n_side), np.linspace(-1, 1, n_side))
    z = 0.3 * np.sin(2 * x) + 0.2 * np.cos(3 * y)
    pts = np.stack([x.ravel(), y.ravel(), z.ravel()], 1)
    return pts + rng.normal(0, noise, pts.shape)


def _moved(tgt):
    T_true = np.eye(4)
    T_true[:3, :3] = Rotation.from_euler(
        "xyz", [0.5, -0.4, 0.3], degrees=True).as_matrix()
    T_true[:3, 3] = [0.01, -0.008, 0.012]
    inv = np.linalg.inv(T_true)
    return tgt @ inv[:3, :3].T + inv[:3, 3], T_true


def test_native_sources_are_the_port_copies():
    names = sorted(p.name for p in native._SRC.iterdir())
    assert names == ["capi.h", "icp_capi.cc", "kdtree.h", "knn_capi.cc",
                     "registration.cc", "registration.h"]
    for name in names:
        text = (native._SRC / name).read_text()
        assert "omp_set_num_threads(" not in text.replace(
            "never omp_set_num_threads", "")
        assert "omp critical" not in text


def test_kdtree_knn_exact():
    from scipy.spatial import cKDTree

    pts = np.random.default_rng(0).normal(size=(3000, 3))
    idx, d2 = native.KdTree(pts).batch_knn_search(pts, 6)
    d, i = cKDTree(pts).query(pts, k=6)
    assert (idx == i).all()
    np.testing.assert_allclose(d2, d**2, rtol=1e-10)


def test_normals_on_plane():
    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(-1, 1, 2000), rng.uniform(-1, 1, 2000),
                    np.zeros(2000)], 1)
    normals, covs = native.KdTree(pts).estimate_normals_covariances(10)
    assert np.abs(normals[:, 2]).min() > 0.999
    w = np.linalg.eigvalsh(covs[0])
    assert w[0] < 0.01 * w[2]  # plane-regularized: smallest ~ eps * others


def test_voxel_downsample():
    pts = np.random.default_rng(2).uniform(0, 1, (5000, 3))
    down = native.voxel_downsample(pts, 0.25)
    assert 30 <= down.shape[0] <= 64  # 4x4x4 grid
    assert down.min() >= 0 and down.max() <= 1


@pytest.mark.parametrize("rtype", ["ICP", "PLANE_ICP", "GICP"])
def test_registration_recovers_transform(rtype):
    tgt = _surface_cloud()
    src, T_true = _moved(tgt)
    res = native.align(tgt, src, registration_type=rtype,
                       max_correspondence_distance=0.3, max_iterations=50)
    err_t = np.linalg.norm(res.T_target_source[:3, 3] - T_true[:3, 3])
    dR = res.T_target_source[:3, :3] @ T_true[:3, :3].T
    err_r = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert err_t < 1e-3, (rtype, err_t)
    assert err_r < 0.05, (rtype, err_r)
    assert res.inliers == tgt.shape[0]


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("rtype", ["ICP", "PLANE_ICP", "GICP", "COLORED_ICP"])
def test_align_repeats_bit_for_bit(rtype, threads):
    """The partial normal equations join in a fixed order: the same call
    gives the same transform, error and inliers bit for bit."""
    tgt = _surface_cloud(40, seed=3)
    src, _ = _moved(tgt)
    col = 0.5 + 0.4 * np.sin(4 * tgt[:, 0]) * np.cos(3 * tgt[:, 1])

    def run():
        if rtype == "COLORED_ICP":
            return native.align_colored(tgt, src, col, col,
                                        max_correspondence_distance=0.3,
                                        num_threads=threads)
        return native.align(tgt, src, registration_type=rtype,
                            max_correspondence_distance=0.3,
                            max_iterations=30, num_threads=threads)

    a, b = run(), run()
    assert np.array_equal(a.T_target_source, b.T_target_source)
    assert (a.error, a.iterations, a.inliers) == (b.error, b.iterations,
                                                  b.inliers)


def test_colored_icp_constrains_flat_plane():
    """On a flat plane geometry leaves the lateral slide free; the colour
    term pins it."""
    x, y = np.meshgrid(np.linspace(-1, 1, 60), np.linspace(-1, 1, 60))
    tgt = np.stack([x.ravel(), y.ravel(), np.zeros(3600)], 1)
    col = (0.5 + 0.5 * np.sin(6 * x) * np.cos(5 * y)).ravel()
    T_true = np.eye(4)
    T_true[:3, 3] = [0.02, -0.015, 0.0]
    inv = np.linalg.inv(T_true)
    src = tgt @ inv[:3, :3].T + inv[:3, 3]
    res_c = native.align_colored(tgt, src, col, col,
                                 max_correspondence_distance=0.3)
    res_p = native.align(tgt, src, registration_type="PLANE_ICP",
                         max_correspondence_distance=0.3, max_iterations=30)
    assert np.linalg.norm(res_c.T_target_source[:3, 3] - T_true[:3, 3]) < 1e-6
    assert np.linalg.norm(res_p.T_target_source[:3, 3] - T_true[:3, 3]) > 0.02


def test_point_cloud_preprocess():
    pc = native.PointCloud(_surface_cloud(30)).preprocess(10)
    assert len(pc) == 900 and pc.normals.shape == (900, 3)
    assert pc.covs.shape == (900, 3, 3)
    assert len(pc.downsample(0.5)) < len(pc)


def test_icp_experiment_on_synthetic(tmp_path):
    ds = SyntheticBoxRoom(n_frames=5, height=48, width=64, speed=2.0)
    out = icp.ICPExperiment(ds, registration_type="GICP",
                            run_dir=tmp_path / "icp", max_images=5,
                            device=CPU).run()
    assert len(out["eT"]) == 4
    # per-frame GT-init alignment on clean synthetic depth: sub-cm error
    assert out["ate_rmse"] < 0.02, out["ate_rmse"]


@pytest.mark.parametrize("rtype", ["COLORED_ICP", "HYBRID"])
def test_icp_experiment_new_methods(tmp_path, rtype):
    ds = SyntheticBoxRoom(n_frames=4, height=48, width=64, speed=2.0)
    out = icp.ICPExperiment(ds, registration_type=rtype,
                            run_dir=tmp_path / rtype, max_images=4,
                            device=CPU).run()
    assert len(out["eT"]) == 3
    assert out["ate_rmse"] < 0.05, (rtype, out["ate_rmse"])
    cfg = json.loads((tmp_path / rtype / "config.json").read_text())
    assert cfg["device"] == "cpu" and cfg["algorithm"] == rtype


@pytest.fixture(scope="module")
def reference_native(tmp_path_factory):
    """The reference's native module on its own sources, built into a
    temporary directory with its own flags (its build_library and its
    tracked library untouched)."""
    out = tmp_path_factory.mktemp("reference_native") / "libref.so"
    srcs = sorted(jnative._SRC.glob("*.cc"))
    subprocess.run(["g++", "-O3", "-march=native", "-fPIC", "-shared",
                    "-std=c++17", "-fopenmp", f"-I{jnative._SRC}",
                    *map(str, srcs), "-o", str(out)], check=True,
                   capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "build_library", lambda force=False: out)
        jnative._load()
        assert isinstance(jnative._lib, ctypes.CDLL)
        yield jnative


@pytest.mark.parametrize("rtype", ["ICP", "PLANE_ICP", "GICP"])
def test_experiment_matches_the_reference(reference_native, tmp_path, rtype):
    """The same 4-frame SyntheticBoxRoom through both ICPExperiments: the
    per-frame GT-init protocol, the back-projection and the metrics agree,
    pair by pair."""
    kw = dict(n_frames=4, height=48, width=64, speed=2.0)
    want = jicp.ICPExperiment(JSyntheticBoxRoom(**kw), registration_type=rtype,
                              run_dir=tmp_path / "ref", max_images=4).run()
    got = icp.ICPExperiment(SyntheticBoxRoom(**kw), registration_type=rtype,
                            run_dir=tmp_path / "port", max_images=4,
                            device=CPU).run()
    assert len(got["eT"]) == len(want["eT"]) == 3
    np.testing.assert_allclose(got["eT"], want["eT"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["eR"], want["eR"], atol=1e-4, rtol=0)
    assert abs(got["ate_rmse"] - want["ate_rmse"]) < 1e-6


def test_sweep_ledger_resumes(tmp_path):
    def factory(scene):
        return SyntheticBoxRoom(n_frames=3, height=32, width=48)

    res1 = icp.run_icp_sweep(factory, ["roomA"], methods=["ICP"],
                             run_root=tmp_path / "sweep", max_images=3,
                             device=CPU)
    assert ("roomA", "ICP") in res1
    ledger = (tmp_path / "sweep" / "finished.jsonl").read_text().splitlines()
    assert [json.loads(x)["method"] for x in ledger] == ["ICP"]
    # a second run resumes: nothing re-run, the ledger unchanged
    res2 = icp.run_icp_sweep(factory, ["roomA"], methods=["ICP"],
                             run_root=tmp_path / "sweep", max_images=3,
                             device=CPU)
    assert res2 == {}
    assert (tmp_path / "sweep" / "finished.jsonl").read_text().splitlines() \
        == ledger


def test_cli_icp_on_the_cpu(tmp_path, capsys):
    cli.main(["icp", "--device", "cpu", "--dataset", "Synthetic",
              "--methods", "ICP", "HYBRID", "--frames", "3", "--height", "32",
              "--width", "48", "--run-dir", str(tmp_path)])
    assert "synthetic/ICP: ATE-RMSE" in capsys.readouterr().out
    done = [json.loads(x)["method"] for x in
            (tmp_path / "finished.jsonl").read_text().splitlines()]
    assert done == ["ICP", "HYBRID"]
    assert len(fixture_compare.icp_pairs(tmp_path / "synthetic_HYBRID")
               ["eT"]) == 2


def test_cli_icp_refuses_the_cpu_by_itself(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["icp", "--dataset", "Synthetic", "--run-dir",
                  str(tmp_path)])
    assert not (tmp_path / "finished.jsonl").exists()


def test_reference_json_rebuilds_from_the_run_records(tmp_path, monkeypatch):
    """tools/build_fixture_reference.py run again on runs/ writes the
    committed fixture_reference.json byte for byte (Replica rooms, TUM
    scenes and the room0 baselines)."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import build_fixture_reference as build
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(build, "OUT", tmp_path / "fixture_reference.json")
    monkeypatch.setattr(build, "REPO", ROOT)
    build.main()
    assert (tmp_path / "fixture_reference.json").read_bytes() == \
        fixture_compare.REFERENCE.read_bytes()


@pytest.mark.parametrize("method", ["ICP", "PLANE_ICP", "GICP",
                                    "COLORED_ICP", "HYBRID"])
def test_icp_records_against_the_run_files(method):
    """Each baseline record: 39 pairs (40 frames), eT and eR and the
    RMSEs equal to the run's files, and compare_icp of the files against
    the record is 1.0 everywhere."""
    ref = fixture_compare.load_reference()["icp"][f"room0_{method}"]
    assert ref["frames"] == 40 and len(ref["pairs"]) == 39
    assert ref["config"]["algorithm"] == method
    recs = [json.loads(x) for x in
            (ROOT / ref["source"] / "metrics.jsonl").read_text().splitlines()]
    assert [p["eT"] for p in ref["pairs"]] == [r["eT"] for r in recs
                                               if "eT" in r]
    assert ref["ate_rmse"] == recs[-1]["ate_rmse"]
    c = fixture_compare.compare_icp(ROOT / ref["source"], "room0", method)
    assert c["ate_ratio"] == 1.0 and set(c["eT_ratio"]) == {1.0}
    with pytest.raises(ValueError, match="beyond"):
        fixture_compare.compare_icp(ROOT / ref["source"], "room0", method,
                                    range(0, 45))
