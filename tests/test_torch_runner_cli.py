"""The port's entry point on the CPU: the sequence runner, its loggers and
checkpoints, the metrics and the `track` / `tables` CLI, on the generated
Synthetic sequence (no files), held against the reference's runner where
both can run the same configuration."""

import json

import numpy as np
import pytest
import torch

from gsplatloc_tpu.eval import logger as jlogger
from gsplatloc_tpu.eval import metrics as jmetrics
from gsplatloc_tpu.opt.tracking import TrackingConfig as JConfig
from gsplatloc_tpu.tracking.runner import SequenceRunner as JRunner
from gsplatloc_tpu.utils import checkpoint as jckpt
from gsplatloc_tpu_torch import cli, native
from gsplatloc_tpu_torch.convert import config_from_reference
from gsplatloc_tpu_torch.eval import logger as tlogger
from gsplatloc_tpu_torch.eval import metrics as tmetrics
from gsplatloc_tpu_torch.opt.tracking import TrackingConfig
from gsplatloc_tpu_torch.tracking.runner import SequenceRunner
from gsplatloc_tpu_torch.utils import checkpoint as tckpt
from torch_port_helpers import perturbed_c2w, to_np  # noqa: F401  (threads)

H, W = 48, 64
SMALL = dict(data_set="Synthetic", scene_name="", normalize=True,
             backend="fused", height=H, width=W, speed=8.0)


def _runner(tmp_path, name, config, **kw):
    args = dict(SMALL, config=config, run_dir=tmp_path / name, device="cpu")
    args.update(kw)
    return SequenceRunner(**args)


@pytest.mark.parametrize("kcover,max_pairs", [(16, 2), (0, 1)],
                         ids=["kcover16", "kcover0"])
def test_runner_matches_reference_runner(tmp_path, kcover, max_pairs):
    """Both runners on the same Synthetic sequence with grid kNN (the
    reference's exact kNN would rebuild its tracked native library):
    equal steps per pair, per-pair eT within 1e-4 m and eR within 0.02 deg
    (measured 4e-5 m / 0.007 deg: the two step renders round differently
    and Adam carries that along 40 steps)."""
    cfg = JConfig(max_steps=40, patience=20, warmup_steps=5,
                  resort_every=10, kcover=kcover)
    kw = dict(SMALL, max_pairs=max_pairs, n_frames=max_pairs + 1,
              knn_method="grid")
    rj = JRunner(config=cfg, run_dir=tmp_path / "j", **kw).train(
        progress=False)
    rt = SequenceRunner(config=config_from_reference(cfg),
                        run_dir=tmp_path / "t", device="cpu", **kw).train(
        progress=False)
    assert rt.steps == [int(s) for s in rj.steps] == [40] * max_pairs
    np.testing.assert_allclose(rt.eT, rj.eT, rtol=0, atol=1e-4)
    np.testing.assert_allclose(rt.eR, rj.eR, rtol=0, atol=0.02)
    assert set(rt.stage_s) == {"wait", "decode", "knn", "parse", "scene",
                               "optimize", "collect", "step", "render",
                               "loss", "backward", "adam", "read", "rebuild",
                               "select", "launched", "segments",
                               "replayed"}


def test_sequence_runner_kcover0_recovers_pose(tmp_path):
    """The sub-tile path through the runner with exact kNN: the estimate
    beats the no-op baseline (tar pose as the estimate)."""
    r = _runner(tmp_path, "k0", TrackingConfig(max_steps=40, patience=20,
                                               warmup_steps=5, kcover=0),
                max_pairs=1, n_frames=2)
    res = r.train(progress=False)
    assert r.knn_method == "exact"
    d = r.parser[0]
    init = float(tmetrics.translation_error(d.tar_c2w, d.src_c2w))
    assert len(res.eT) == 1 and res.eT[0] < init / 2


def test_prefetch_pipeline_matches_serial(tmp_path):
    """The prefetch worker only reorders host work: bitwise-equal results
    with and without it (exact kNN, the runner's default)."""
    cfg = TrackingConfig(max_steps=20, patience=20, warmup_steps=5)

    def run(prefetch, name):
        r = _runner(tmp_path, name, cfg, max_pairs=3, n_frames=4)
        return r, r.train(progress=False, prefetch=prefetch)

    r_s, serial = run(False, "serial")
    r_p, piped = run(True, "piped")
    assert r_s.knn_method == r_p.knn_method == "exact"
    assert serial.eT == piped.eT
    assert serial.eR == piped.eR
    assert serial.losses == piped.losses
    assert serial.steps == piped.steps
    assert "wait" in piped.stage_s and "wait" not in serial.stage_s
    cfg_json = json.loads((tmp_path / "piped" / "config.json").read_text())
    assert cfg_json["knn_method"] == "exact" and cfg_json["kcover"] == 16


def test_runner_resume(tmp_path):
    def make():
        return _runner(tmp_path, "run",
                       TrackingConfig(max_steps=10, patience=10,
                                      warmup_steps=2),
                       max_pairs=2, n_frames=3, knn_method="grid")

    r1 = make().train(progress=False, checkpoint_every=1)
    assert len(r1.eT) == 2
    # everything already done: no new work, the same series
    r2 = make().train(progress=False, resume=True, checkpoint_every=1)
    assert len(r2.eT) == 2
    np.testing.assert_allclose(r2.eT, r1.eT)


def test_runner_refuses_to_fall_back_from_exact_knn(tmp_path, monkeypatch):
    """knn_method='auto' resolves to the exact KdTree; when its library
    cannot be built the runner raises (the reference would quietly use the
    grid window)."""
    def broken():
        raise RuntimeError("exact-kNN library build failed (test)")

    monkeypatch.setattr(native, "build_library", broken)
    with pytest.raises(RuntimeError, match="exact-kNN"):
        _runner(tmp_path, "x", TrackingConfig(max_steps=2), n_frames=2)


def test_checkpoint_roundtrip(tmp_path):
    poses = [np.eye(4, dtype=np.float32) for _ in range(3)]
    tckpt.save_checkpoint(tmp_path, 3, poses, [0.1, 0.2, 0.3], [1, 2, 3],
                          [0.01] * 3, [100, 120, 90], extra={"wall_s": 2.5})
    nxt, state = tckpt.load_checkpoint(tmp_path)
    assert nxt == 3 and len(state["poses_est"]) == 3
    np.testing.assert_allclose(state["eT"], [0.1, 0.2, 0.3])
    assert state["wall_s"] == 2.5
    assert tckpt.load_checkpoint(tmp_path / "missing") == (0, None)
    # the two packages read each other's checkpoints
    nxt_j, state_j = jckpt.load_checkpoint(tmp_path)
    assert nxt_j == 3
    for k in ("eT", "eR", "losses", "steps"):
        np.testing.assert_array_equal(state_j[k], state[k])


def test_logger_jsonl_and_series(tmp_path):
    lg = tlogger.ExperimentLogger(tmp_path / "run", config={"a": 1})
    lg.log(0, eT=0.1, eR=0.2)
    lg.log(1, eT=0.05, eR=0.1, stage_s={"optimize": 1.5})
    lg.finish()
    lines = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2
    assert json.loads(lines[0])["eT"] == 0.1
    assert json.loads(lines[1])["stage_s"] == {"optimize": 1.5}
    assert lg.values("eT") == [0.1, 0.05]
    assert json.loads((tmp_path / "run" / "config.json").read_text())["a"] == 1


def test_res_json_and_tables_match_reference(tmp_path):
    results = {
        "Replica": {
            "room0": {"ours": {"eT": [0.001, 0.002], "eR": [0.1, 0.2],
                               "steps_per_s": 12.5}},
            "room1": {"ours": {"eT": [0.003], "eR": [0.3]},
                      "other": {"eT": [0.004], "eR": [0.5]}},
        }
    }
    res_t = tlogger.write_res_json(results, tmp_path / "t.json")
    res_j = jlogger.write_res_json(results, tmp_path / "j.json")
    assert res_t == res_j
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    for metric, scale in (("ate_rmse", 100.0), ("aae_rmse", 1.0)):
        assert (tlogger.results_markdown_table(res_t, "Replica", metric, scale)
                == jlogger.results_markdown_table(res_j, "Replica", metric,
                                                  scale))


def test_aggregate_runs_matches_reference(tmp_path):
    root = tmp_path / "runs"
    for d, room, e_t in ((root / "a" / "room0", "room0", [0.001, 0.002]),
                         (root / "b" / "room1", "room1", [0.003])):
        d.mkdir(parents=True)
        (d / "config.json").write_text(json.dumps(
            {"dataset": "Replica", "scene": room, "algorithm": "ours"}))
        with open(d / "metrics.jsonl", "w") as f:
            for i, t in enumerate(e_t):
                f.write(json.dumps({"step": i, "eT": t, "eR": 10 * t}) + "\n")
            f.write(json.dumps({"step": 9, "pose_steps_per_s": 7.0}) + "\n")
    assert tlogger.aggregate_runs(root) == jlogger.aggregate_runs(root)


def test_metrics_match_reference():
    rng = np.random.default_rng(3)
    a = perturbed_c2w((0.3, -0.2, 0.1), (0.01, 0.02, -0.03))
    b = perturbed_c2w((0.31, -0.2, 0.1), (0.0101, 0.02, -0.03))
    np.testing.assert_allclose(
        float(tmetrics.translation_error(torch.as_tensor(a),
                                         torch.as_tensor(b))),
        float(jmetrics.translation_error(a, b)), rtol=1e-6)
    for deg in (1e-3, 5e-3):
        from scipy.spatial.transform import Rotation

        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("y", deg, degrees=True).as_matrix()
        e = float(tmetrics.rotation_error_deg(torch.as_tensor(T),
                                              np.eye(4)))
        assert abs(e - deg) < 0.2 * deg
        assert e == float(jmetrics.rotation_error_deg(T, np.eye(4)))
    v = rng.random(7)
    assert tmetrics.rmse(v) == jmetrics.rmse(v)
    assert np.isnan(tmetrics.rmse([]))
    p, q = rng.random((50, 3)).astype(np.float32), rng.random((50, 3)).astype(
        np.float32)
    for f in ("pointcloud_rmse", "com_difference"):
        np.testing.assert_allclose(
            float(getattr(tmetrics, f)(torch.as_tensor(p), torch.as_tensor(q))),
            float(getattr(jmetrics, f)(p, q)), rtol=1e-5)
    d1, d2 = rng.random((2, 12, 16)).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tmetrics.silhouette_diff(torch.as_tensor(d1),
                                       torch.as_tensor(d2))),
        np.asarray(jmetrics.silhouette_diff(d1, d2)), atol=1e-6)
    tmetrics.set_random_seed(5)
    x = (np.random.random(), torch.rand(1).item())
    tmetrics.set_random_seed(5)
    assert (np.random.random(), torch.rand(1).item()) == x


def test_cli_track_synthetic(tmp_path, capsys):
    cli.main([
        "track", "--device", "cpu", "--dataset", "Synthetic", "--frames",
        "3", "--height", "32", "--width", "48", "--num-iters", "20",
        "--max-pairs", "2", "--kcover", "0", "--run-dir",
        str(tmp_path / "cli"), "--quiet",
    ])
    out = capsys.readouterr().out
    assert "ATE-RMSE" in out
    res = json.loads((tmp_path / "cli" / "res.json").read_text())
    rec = res["Synthetic"]["synthetic"]["gsplatloc_tpu"]
    assert np.isfinite(rec["ate_rmse"]) and np.isfinite(rec["aae_rmse"])
    cfg = json.loads((tmp_path / "cli" / "synthetic" / "config.json")
                     .read_text())
    assert (cfg["kcover"], cfg["knn_method"], cfg["device"]) == (0, "exact",
                                                                 "cpu")


def test_cli_tables(tmp_path, capsys):
    res = {"Replica": {"room0": {"ours": {"ate_rmse": 0.0001,
                                           "aae_rmse": 0.5}}}}
    (tmp_path / "res.json").write_text(json.dumps(res))
    cli.main(["tables", "--res", str(tmp_path / "res.json"),
              "--dataset", "Replica"])
    out = capsys.readouterr().out
    assert "ATE RMSE" in out and "0.01000" in out


def test_cli_defaults_are_the_product_config():
    """The CLI's defaults are the reference's flags and TrackingConfig's
    product values; the card is the default device."""
    from gsplatloc_tpu.cli import build_parser as j_build_parser

    args = cli.build_parser().parse_args(["track"])
    ref = j_build_parser().parse_args(["track"])
    cfg = TrackingConfig()
    assert args.device == "cuda" and args.backend == "fused"
    assert args.kcover == cfg.kcover == ref.kcover == 16
    assert args.select_gate == cfg.select_motion_px == ref.select_gate
    assert args.resort_gate == cfg.resort_motion_px == ref.resort_gate
    assert args.coast_after_steps == cfg.coast_after_steps
    shared = set(vars(ref)) - {"platform", "fn"}
    assert shared <= set(vars(args))
    for k in shared:
        assert getattr(args, k) == getattr(ref, k), k
