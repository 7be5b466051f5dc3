"""The port's file-less Replica fixture source against the files the
reference's script writes, and the reference's records of the fixture
suite carried into the port.

The frames are written by `scripts/make_replica_fixture.py` (its own
`main`, loaded by path: the script is no module of either package) at
68x120 (fx 60) and read back through the port's OpenCV `Replica` loader;
`ReplicaFixture` must give the same depth and pose bit for bit, the same
K, and the colour the script encoded before its JPEG round trip."""

import importlib.util
import json
import pathlib
import pickle
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from gsplatloc_tpu.data import parser as jparser
from gsplatloc_tpu.data.synthetic import box_room_frame as j_box_room_frame
from gsplatloc_tpu.data.synthetic import (
    box_room_trajectory as j_box_room_trajectory,
)
from gsplatloc_tpu_torch import cli
from gsplatloc_tpu_torch.data import fixtures
from gsplatloc_tpu_torch.data.datasets import Replica, get_dataset
from gsplatloc_tpu_torch.data.fixtures import ReplicaFixture
from gsplatloc_tpu_torch.data.parser import Parser
from gsplatloc_tpu_torch.eval import fixture_compare
from gsplatloc_tpu_torch.models.gaussians import scene_from_point_cloud
from gsplatloc_tpu_torch.opt.tracking import TrackingConfig, optimize_pose
from gsplatloc_tpu_torch.tracking import runner
from helpers import assert_close_except_gate_flips
from torch_port_helpers import to_np

ROOT = pathlib.Path(__file__).resolve().parent.parent
H, W, N_FRAMES = 68, 120, 3
ROOMS = ("room0", "room2", "office1")  # no noise; noise; boxes and noise
# the run records the reference JSON was built from
SOURCES = {
    **{r: f"runs/tpu_session_r5b/suite/replica/{r}" for r in (
        "room0", "room1", "room2", "office0", "office1", "office2",
        "office3", "office4")},
    "dense0": "runs/tpu_session_r5b/suite/replica_dense0/dense0",
    "dense1": "runs/tpu_session_r5e/dense1/dense1",
}


def _script():
    spec = importlib.util.spec_from_file_location(
        "make_replica_fixture", ROOT / "scripts" / "make_replica_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The three rooms as the script writes them, through its own main."""
    out = tmp_path_factory.mktemp("replica_fixture")
    argv = sys.argv
    sys.argv = ["make_replica_fixture.py", "--frames", str(N_FRAMES),
                "--height", str(H), "--width", str(W), "--out", str(out),
                "--rooms", *ROOMS]
    try:
        _script().main()
    finally:
        sys.argv = argv
    return out


def test_rooms_and_camera_equal_the_script(written):
    assert fixtures.ROOMS == _script().ROOMS
    assert ReplicaFixture.ROOMS == Replica.ROOMS + ["dense0", "dense1"]
    assert sorted(ReplicaFixture.ROOMS) == sorted(fixtures.ROOMS)
    cam = json.loads((written / "cam_params.json").read_text())["camera"]
    assert fixtures.camera_config(H, W) == cam
    assert cam["fx"] == 60.0


@pytest.mark.parametrize("room", ROOMS)
def test_source_equals_the_files(written, room):
    """Depth and c2w bit-equal, K equal; colour the array the script gave
    its JPEG encoder, which decodes to exactly what the loader reads.
    room2 is read out of order (its noise is drawn in frame order)."""
    order = (2, 0, 1) if room == "room2" else (0, 1, 2)
    files = Replica(room, root=written)
    src = ReplicaFixture(room, frames=N_FRAMES, height=H, width=W,
                         workers=2)
    try:
        assert len(src) == len(files) == N_FRAMES
        np.testing.assert_array_equal(src.K, files.K)
        assert src.K.dtype == files.K.dtype == np.float32
        clutter, speed, _noise, seed, boxes = fixtures.ROOMS[room]
        poses = j_box_room_trajectory(N_FRAMES, seed=seed, speed=speed)
        for i in order:
            a, b = src[i], files[i]
            assert a.depth.dtype == b.depth.dtype == np.float64
            assert a.c2w.dtype == b.c2w.dtype == np.float32
            np.testing.assert_array_equal(a.depth, b.depth)
            np.testing.assert_array_equal(a.c2w, b.c2w)
            rgb, _ = j_box_room_frame(poses[i], files.K, H, W,
                                      clutter=clutter, boxes=boxes)
            bgr = (rgb[..., ::-1] * 255).astype(np.uint8)
            np.testing.assert_array_equal(a.rgb, bgr.astype(np.float64))
            ok, jpg = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 95])
            assert ok
            np.testing.assert_array_equal(
                cv2.imdecode(jpg, cv2.IMREAD_COLOR).astype(np.float64), b.rgb)
    finally:
        src.close()


def test_source_reads_without_opencv(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2 as _cv2  # noqa: F401
    src = get_dataset("ReplicaFixture", "office1", frames=2, height=H,
                      width=W, workers=1)
    try:
        f = src[1]
    finally:
        src.close()
    assert f.depth.shape == (H, W) and f.rgb.shape == (H, W, 3)
    assert np.isfinite(f.depth).all() and (f.depth > 0).all()


def test_render_worker_imports_numpy_only():
    """The worker, run as the pool runs it, renders a job and imports
    neither torch nor OpenCV nor JAX (nor this package's __init__)."""
    job = dict(c2w=np.eye(4, dtype=np.float32),
               K=np.array([[6.0, 0, 5.5], [0, 6.0, 3.5], [0, 0, 1]],
                          np.float32), height=8, width=12, clutter=3, boxes=2)
    out = subprocess.run(
        [sys.executable, "-X", "importtime", str(fixtures.WORKER)],
        input=pickle.dumps(job), capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    status, bgr, depth = pickle.loads(out.stdout)
    assert status == "ok" and bgr.dtype == np.uint8 and depth.dtype == np.float32
    rgb, want = j_box_room_frame(job["c2w"], job["K"], 8, 12, clutter=3,
                                 boxes=2)
    np.testing.assert_array_equal(depth, want)
    np.testing.assert_array_equal(bgr, (rgb[..., ::-1] * 255).astype(np.uint8))
    imported = {line.split("|")[-1].strip().split(".")[0]
                for line in out.stderr.decode().splitlines()
                if line.startswith("import time:")}
    assert "numpy" in imported
    assert not imported & {"torch", "cv2", "jax", "gsplatloc_tpu",
                           "gsplatloc_tpu_torch"}, imported


def test_render_worker_error_reaches_the_caller():
    pool = fixtures.RenderPool(1)
    try:
        with pytest.raises(RuntimeError, match="fixture render failed"):
            pool.submit(c2w=np.eye(4), K=np.eye(3), height=-1, width=4,
                        clutter=0, boxes=0).result(timeout=120)
        # the worker lives on and takes the next job
        bgr, depth = pool.submit(c2w=np.eye(4), K=np.eye(3, dtype=np.float32),
                                 height=2, width=3, clutter=0,
                                 boxes=0).result(timeout=120)
        assert bgr.shape == (2, 3, 3) and depth.shape == (2, 3)
    finally:
        pool.close()
    assert not pool._procs


def test_unknown_room_is_refused():
    with pytest.raises(ValueError, match="unknown fixture room"):
        ReplicaFixture("room9")


def _align_signs(a_c2w, b_c2w):
    """Diagonal signs mapping one PCA frame onto another (the 2nd/3rd axes
    may be mirrored together between two eigensolvers)."""
    a, b = to_np(a_c2w), to_np(b_c2w)
    return np.sign(np.sum(a[:3, :3] * b[:3, :3], axis=1)).astype(np.float32)


def test_parsers_agree_on_the_same_input(written):
    """The reference's Parser on the written files against the port's on
    the source, pair 0 of room0 at 68x120, at the tolerances of
    tests/test_torch_scene_parser.py (grid kNN in both: the reference's
    exact kNN may rebuild its tracked library). Colours are left out:
    the files carry the JPEG's (test_colour_does_not_reach_the_pose)."""
    ref = jparser.Parser("Replica", "room0", backend="subtile",
                         knn_method="grid", root=str(written))[0]
    port = Parser("ReplicaFixture", "room0", backend="subtile",
                  knn_method="grid", device="cpu", frames=N_FRAMES,
                  height=H, width=W)
    try:
        got = port[0]
    finally:
        port.dataset.close()
    s = _align_signs(got.tar_c2w, ref.tar_c2w)
    for field in ("tar_points", "src_points"):
        np.testing.assert_allclose(to_np(getattr(got, field)) * s[None, :],
                                   to_np(getattr(ref, field)), atol=2e-4)
    for field in ("tar_c2w", "src_c2w"):
        a = to_np(getattr(got, field)).copy()
        a[:3, :] = a[:3, :] * s[:, None]
        np.testing.assert_allclose(a, to_np(getattr(ref, field)), atol=2e-4)
    np.testing.assert_allclose(to_np(got.pca_factor), to_np(ref.pca_factor),
                               atol=2e-5)
    d_t, d_j = to_np(got.src_depth), to_np(ref.src_depth)
    assert d_t.shape == d_j.shape == (H, W)
    covered = (d_t > 0) & (d_j > 0)
    assert covered.mean() > 0.9
    assert ((d_t > 0) != (d_j > 0)).mean() <= 0.005
    assert_close_except_gate_flips(d_t[covered], d_j[covered], atol=1e-4,
                                   flip_abs=0.3)


def test_colour_does_not_reach_the_pose(written):
    """A short CPU track of pair 0 with the source's colours and one with
    the JPEG-decoded colours of the files give the same best pose, bit for
    bit: colour reaches only the SH DC term, the loss is depth-only."""
    results = []
    for p in (Parser("ReplicaFixture", "office1", backend="subtile",
                     knn_method="grid", device="cpu", frames=N_FRAMES,
                     height=H, width=W),
              Parser("Replica", "office1", backend="subtile",
                     knn_method="grid", device="cpu", root=written)):
        data = p[0]
        if isinstance(p.dataset, ReplicaFixture):
            p.dataset.close()
        scene = scene_from_point_cloud(data.tar_points, data.colors,
                                       grid_shape=(H, W), device="cpu")
        out = optimize_pose(scene, data.tar_c2w, data.src_depth, p.K, W, H,
                            config=TrackingConfig(max_steps=40,
                                                  warmup_steps=10),
                            device="cpu")
        results.append((data, out))
    (d0, o0), (d1, o1) = results
    assert not torch.equal(d0.colors, d1.colors)
    assert torch.equal(d0.src_depth, d1.src_depth)
    assert torch.equal(o0.best_pose.quat, o1.best_pose.quat)
    assert torch.equal(o0.best_pose.trans, o1.best_pose.trans)
    assert torch.equal(o0.best_loss, o1.best_loss)
    assert o0.steps_run == o1.steps_run


def test_clamp_counts_at_full_size_equal_the_reference():
    """room0's frames 2, 3 and 4 at 1200x680 through the exact kNN and the
    runner's clamp count give the counts the reference logged for its
    pairs 2, 3 and 4 (host work in both packages)."""
    p = Parser("ReplicaFixture", "room0", backend="subtile",
               knn_method="exact", device="cpu", frames=5, workers=3)
    try:
        got = [runner.clamped_count(p.knn_for_frame(i)) for i in (2, 3, 4)]
    finally:
        p.dataset.close()
    ref = fixture_compare.load_reference()["rooms"]["room0"]["pairs"]
    assert got == [ref[i]["clamped_scales"] for i in (2, 3, 4)] == [0, 4, 3]


def test_reference_json_equals_the_run_records():
    """fixture_reference.json field for field against the files in runs/
    it was built from, with nothing of the reference's speed kept."""
    ref = fixture_compare.load_reference()
    assert list(ref["rooms"]) == list(SOURCES)
    speed = {"ts", "steps_per_s", "pose_steps_per_s", "wall_s", "stage_s"}
    for room, rel in SOURCES.items():
        d = ROOT / rel
        recs = [json.loads(line)
                for line in (d / "metrics.jsonl").read_text().splitlines()]
        pairs = [r for r in recs if "eT" in r]
        got = ref["rooms"][room]
        assert got["source"] == rel
        assert len(got["pairs"]) == len(pairs) == got["frames"] - 1
        clamped = {r["step"]: r["clamped_scales"] for r in recs
                   if "clamped_scales" in r}
        for rec in pairs:
            mine = got["pairs"][rec["step"]]
            for k in ("eT", "eR", "best_loss", "steps", "rebuilds",
                      "selects"):
                assert mine[k] == rec[k], (room, rec["step"], k)
            assert mine["clamped_scales"] == clamped.get(rec["step"], 0)
            assert not set(mine) & speed
        summary = [r for r in recs if "ate_rmse" in r][-1]
        assert (got["ate_rmse"], got["aae_rmse"]) == (
            summary["ate_rmse"], summary["aae_rmse"])
        cfg = json.loads((d / "config.json").read_text())
        assert cfg.pop("scene") == room
        assert cfg == ref["config"]
        assert not set(got) & speed
    assert ref["config"]["max_steps"] == 2000
    assert ref["config"]["knn_method"] == "exact"


@pytest.mark.parametrize("room", ["room0", "dense0", "dense1"])
def test_compare_holds_the_records_against_themselves(room):
    c = fixture_compare.compare(ROOT / SOURCES[room], room, range(2, 7))
    assert c["pairs"] == [2, 3, 4, 5, 6]
    assert c["ate_ratio"] == 1.0 and c["eT_ratio"] == [1.0] * 5
    assert c["clamped_equal"]
    assert c["port"]["ate_rmse"] == c["reference"]["ate_rmse"] > 0
    with pytest.raises(ValueError, match="beyond"):
        fixture_compare.compare(ROOT / SOURCES[room], room, range(0, 90))


def test_runner_result_and_its_records_compare_alike(tmp_path):
    """A CPU run's SequenceResult and its metrics.jsonl give the same
    comparison; the clamp counts reach both."""
    r = runner.SequenceRunner(
        "ReplicaFixture", "room2", config=TrackingConfig(max_steps=12),
        run_dir=tmp_path / "room2", knn_method="exact", device="cpu",
        frames=3, height=H, width=W)
    try:
        res = r.train(progress=False)
    finally:
        r.parser.dataset.close()
    assert len(res.clamped_scales) == len(res.rebuilds) == 2
    a = fixture_compare.compare(res, "room2")
    b = fixture_compare.compare(tmp_path / "room2", "room2")
    assert a == b
    assert a["port"]["steps"] == res.steps
    assert a["port"]["slot_overflow"] == res.slot_overflow


def test_cli_track_runs_every_fixture_room(monkeypatch, tmp_path):
    """`--all` takes the ten fixture rooms, `--frames` their length (40
    by default, as for Synthetic); the runner gets no data root."""
    made = []

    class FakeRunner:
        def __init__(self, data_set, scene_name, **kw):
            made.append((data_set, scene_name, kw["frames"], kw["height"],
                         kw["width"], "root" in kw))

        def train(self, progress, prefetch):
            return runner.SequenceResult(eT=[0.0], eR=[0.0], steps=[1],
                                         wall_s=1.0)

    monkeypatch.setattr(runner, "SequenceRunner", FakeRunner)
    cli.main(["track", "--dataset", "ReplicaFixture", "--all", "--device",
              "cpu", "--quiet", "--run-dir", str(tmp_path)])
    assert [m[1] for m in made] == ReplicaFixture.ROOMS
    assert all(m == ("ReplicaFixture", m[1], 40, 680, 1200, False)
               for m in made)
    made.clear()
    cli.main(["track", "--dataset", "ReplicaFixture", "--rooms", "dense1",
              "--frames", "80", "--device", "cpu", "--quiet", "--run-dir",
              str(tmp_path)])
    assert made == [("ReplicaFixture", "dense1", 80, 680, 1200, False)]
    res = json.loads((tmp_path / "res.json").read_text())
    assert list(res["ReplicaFixture"]) == ["dense1"]


def test_cli_track_on_a_fixture_room(tmp_path):
    """The whole entry point on the CPU at 68x120: one run directory per
    room, its config naming the dataset, the comparison readable."""
    cli.main(["track", "--device", "cpu", "--dataset", "ReplicaFixture",
              "--rooms", "office1", "--frames", "3", "--height", str(H),
              "--width", str(W), "--num-iters", "12", "--knn", "grid",
              "--quiet", "--run-dir", str(tmp_path)])
    cfg = json.loads((tmp_path / "office1" / "config.json").read_text())
    assert (cfg["dataset"], cfg["scene"]) == ("ReplicaFixture", "office1")
    c = fixture_compare.compare(tmp_path / "office1", "office1")
    assert c["pairs"] == [0, 1]
    assert all(np.isfinite(c["port"]["eT"]))
