"""The general rasterizer's path as a whole on the CPU: optimize_pose and
optimize_pose_recorded with backend "pallas" (the plain versions of the
tiled kernels) and "reference" (the dense oracle) against the JAX package
from the same frame pair, the depth target render_depth_gt, and the
runner / `cli track --backend pallas` writing res.json."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplatloc_tpu.data.synthetic import random_gaussian_cloud
from gsplatloc_tpu.data import parser as jparser
from gsplatloc_tpu.models.gaussians import scene_from_point_cloud
from gsplatloc_tpu.ops.lie import invert_se3
from gsplatloc_tpu.ops.rasterize import rasterize as j_rasterize
from gsplatloc_tpu.opt.tracking import TrackingConfig as JConfig
from gsplatloc_tpu.opt.tracking import optimize_pose as j_optimize_pose
from gsplatloc_tpu.opt.tracking import (
    optimize_pose_recorded as j_optimize_pose_recorded,
)
from gsplatloc_tpu_torch import cli, kernels
from gsplatloc_tpu_torch.convert import config_from_reference, scene_from_numpy
from gsplatloc_tpu_torch.data import parser as tparser
from gsplatloc_tpu_torch.opt.tracking import (
    TrackingConfig, optimize_pose, optimize_pose_recorded,
)
from gsplatloc_tpu_torch.tracking.runner import SequenceRunner
from torch_port_helpers import perturbed_c2w, to_np

H, W = 48, 64  # three tile rows, one (partial) tile column
CFG = JConfig(max_steps=24, patience=20, warmup_steps=5, resort_every=10)


@pytest.fixture(scope="module")
def pair():
    """400 random splats (scale 0.08, opacity 1) seen from a displaced
    camera; the depth target is the reference's tiled render there."""
    rng = np.random.default_rng(7)
    pts, rgb = random_gaussian_cloud(rng, 400)
    scene_j = scene_from_point_cloud(jnp.asarray(pts), jnp.asarray(rgb))
    scene_j = scene_j._replace(scales=jnp.full_like(scene_j.scales, 0.08))
    scene_t = scene_from_numpy(
        {k: np.asarray(getattr(scene_j, k)) for k in scene_j._fields},
        device="cpu")
    K = np.array([[40.0, 0, W / 2 - 0.5], [0, 40.0, H / 2 - 0.5], [0, 0, 1]],
                 np.float32)
    gt = perturbed_c2w((0.7, -0.4, 0.3), (0.012, -0.01, 0.018))
    r, _ = j_rasterize(scene_j.means, scene_j.quats, scene_j.scales,
                       scene_j.opacities, scene_j.sh_coeffs,
                       invert_se3(jnp.asarray(gt)), jnp.asarray(K), W, H,
                       sh_degree=1, render_mode="ED", backend="pallas")
    return dict(scene_j=scene_j, scene_t=scene_t, K=K, gt=gt,
                depth_gt=np.asarray(r[..., 0]))


@pytest.mark.parametrize("backend", ["pallas", "reference"])
def test_optimize_pose_general_matches_reference(pair, backend):
    """24 steps from identity: equal steps_run, best and final pose within
    1e-6 and best loss within 1e-5 relative (measured 2.5e-8 / 3.6e-7 on
    the pose: the two renders agree to f32 rounding and Adam's normalized
    update keeps it there); no rebuild, no select; the pose error at
    least halves."""
    rj = j_optimize_pose(pair["scene_j"], jnp.eye(4),
                         jnp.asarray(pair["depth_gt"]),
                         jnp.asarray(pair["K"]), W, H, config=CFG,
                         backend=backend)
    kernels.reset_launch_counts()
    rt = optimize_pose(pair["scene_t"], np.eye(4, dtype=np.float32),
                       pair["depth_gt"], pair["K"], W, H,
                       config=config_from_reference(CFG), backend=backend,
                       device="cpu")
    assert all(v == 0 for v in kernels.launch_counts().values())
    assert rt.steps_run == int(rj.steps_run) == 24
    assert (rt.rebuilds, rt.selects, rt.slot_overflow) == (0, 0, False)
    for f in ("best_pose", "final_pose"):
        np.testing.assert_allclose(to_np(getattr(rt, f).quat),
                                   np.asarray(getattr(rj, f).quat), atol=1e-6)
        np.testing.assert_allclose(to_np(getattr(rt, f).trans),
                                   np.asarray(getattr(rj, f).trans), atol=1e-6)
    np.testing.assert_allclose(float(rt.best_loss), float(rj.best_loss),
                               rtol=1e-5)
    best = to_np(rt.best_pose.to_c2w())
    e_t = np.linalg.norm(best[:3, 3] - pair["gt"][:3, 3])
    assert e_t < np.linalg.norm(pair["gt"][:3, 3]) / 2


def test_optimize_pose_general_early_stop_matches_reference(pair):
    """A patience that runs out inside a segment: the port's masked steps
    stop where the reference's while_loop stops (equal steps_run, best
    pose within 1e-6)."""
    cfg = CFG._replace(max_steps=30, patience=3, warmup_steps=2)
    rj = j_optimize_pose(pair["scene_j"], jnp.eye(4),
                         jnp.asarray(pair["depth_gt"]),
                         jnp.asarray(pair["K"]), W, H, config=cfg,
                         backend="reference")
    rt = optimize_pose(pair["scene_t"], np.eye(4, dtype=np.float32),
                       pair["depth_gt"], pair["K"], W, H,
                       config=config_from_reference(cfg),
                       backend="reference", device="cpu")
    assert rt.steps_run == int(rj.steps_run)
    np.testing.assert_allclose(to_np(rt.best_pose.trans),
                               np.asarray(rj.best_pose.trans), atol=1e-6)


def test_optimize_pose_recorded_matches_reference(pair):
    """8 fixed steps of the general path: the loss series within 1e-5
    relative and the pose trajectory within 1e-6 of the reference's."""
    cfg = CFG._replace(max_steps=8)
    sj = j_optimize_pose_recorded(pair["scene_j"], jnp.eye(4),
                                  jnp.asarray(pair["depth_gt"]),
                                  jnp.asarray(pair["K"]), W, H, n_steps=8,
                                  config=cfg, backend="pallas")
    st = optimize_pose_recorded(pair["scene_t"], np.eye(4, dtype=np.float32),
                                pair["depth_gt"], pair["K"], W, H, n_steps=8,
                                config=config_from_reference(cfg),
                                backend="pallas", device="cpu")
    for k in ("loss", "depth_loss", "silhouette_loss"):
        assert tuple(st[k].shape) == (8,)
        np.testing.assert_allclose(to_np(st[k]), np.asarray(sj[k]),
                                   rtol=1e-5, err_msg=k)
    for k in ("quat", "trans"):
        np.testing.assert_allclose(to_np(st[k]), np.asarray(sj[k]),
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(to_np(st["final_pose"].trans),
                               np.asarray(sj["final_pose"].trans), atol=1e-6)
    assert float(st["loss"][-1]) < float(st["loss"][0])
    with pytest.raises(ValueError):
        optimize_pose_recorded(pair["scene_t"], np.eye(4, dtype=np.float32),
                               pair["depth_gt"], pair["K"], W, H, n_steps=1,
                               backend="fused", device="cpu")


def test_render_depth_gt_general_matches_reference():
    """The depth target through the general rasterizer (ED mode, SH degree
    1, opacity-1 kNN-scaled splats) from a box-room frame: within 1e-4 of
    the reference's on covered pixels, zero on the same pixels, for the
    port's "pallas" (default) and "reference" backends."""
    from gsplatloc_tpu.data.synthetic import box_room_frame

    h, w = 16, 48
    K = np.array([[24.0, 0, w / 2 - 0.5], [0, 24.0, h / 2 - 0.5], [0, 0, 1]],
                 np.float32)
    c2w = perturbed_c2w((1.0, 0.5, -0.5), (0.05, 0.02, -0.03))
    rgb, depth = box_room_frame(np.eye(4), K, h, w)
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    pts = np.stack([(u - K[0, 2]) / K[0, 0] * depth,
                    (v - K[1, 2]) / K[1, 1] * depth, depth],
                   axis=-1).reshape(-1, 3).astype(np.float32)
    cols = rgb.reshape(-1, 3).astype(np.float32)
    d_j = np.asarray(jparser.render_depth_gt(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(K), jnp.asarray(c2w),
        h, w, grid_shape=(h, w), backend="pallas"))
    for backend in ("pallas", "reference"):
        kw = {} if backend == "pallas" else dict(backend=backend)
        d_t = to_np(tparser.render_depth_gt(pts, cols, K, c2w, h, w,
                                            grid_shape=(h, w), device="cpu",
                                            **kw))
        assert d_t.shape == (h, w)
        np.testing.assert_array_equal(d_t == 0, d_j == 0)
        np.testing.assert_allclose(d_t, d_j, atol=1e-4, err_msg=backend)
    assert (d_j > 0).mean() > 0.9


def test_defaults_are_the_reference_defaults():
    """render_depth_gt, _assemble_pair and Parser default to the general
    rasterizer's "pallas", as the reference's do; the CLI's --backend
    default stays "fused"."""
    import inspect

    for fn in (tparser.render_depth_gt, tparser._assemble_pair,
               tparser.Parser.__init__):
        assert inspect.signature(fn).parameters["backend"].default == "pallas"
    for fn in (jparser.render_depth_gt, jparser._assemble_pair,
               jparser.Parser.__init__):
        assert inspect.signature(fn).parameters["backend"].default == "pallas"
    assert cli.build_parser().parse_args(["track"]).backend == "fused"


@pytest.mark.parametrize("backend,parser_backend", [
    ("pallas", "pallas"), ("reference", "reference"), ("fused", "subtile")])
def test_runner_renders_its_depth_target_with_its_own_backend(
        tmp_path, backend, parser_backend):
    r = SequenceRunner("Synthetic", "", backend=backend, knn_method="grid",
                       run_dir=tmp_path, device="cpu", n_frames=2,
                       height=8, width=8)
    assert r.parser.backend == parser_backend and r.backend == backend


def test_runner_and_cli_track_with_the_general_backend(tmp_path):
    """`cli track --backend pallas --device cpu` on a tiny Synthetic
    sequence writes res.json with finite ATE/AAE and the runner's per-pair
    records with finite errors; each pair is tracked by the general path
    (no rebuild, no select)."""
    run = tmp_path / "track"
    cli.main(["track", "--device", "cpu", "--dataset", "Synthetic",
              "--backend", "pallas", "--frames", "3", "--height", "16",
              "--width", "24", "--num-iters", "12", "--knn", "grid",
              "--run-dir", str(run), "--quiet"])
    res = json.loads((run / "res.json").read_text())
    e = res["Synthetic"]["synthetic"]["gsplatloc_tpu"]
    assert np.isfinite(e["ate_rmse"]) and np.isfinite(e["aae_rmse"])
    recs = [json.loads(x) for x in
            (run / "synthetic" / "metrics.jsonl").read_text().splitlines()]
    pairs = [r for r in recs if "eT" in r]
    assert np.isfinite([r["eT"] for r in pairs] + [r["eR"] for r in pairs]).all()
    assert [int(r["steps"]) for r in pairs] == [12, 12]
    assert all(int(r["rebuilds"]) == int(r["selects"]) == 0 for r in pairs)
    cfg = json.loads((run / "synthetic" / "config.json").read_text())
    assert cfg["backend"] == "pallas"


@pytest.mark.parametrize("name", ["subtile_false", "parser_fused",
                                  "unknown_backend"])
def test_fulltile_paths_run_and_an_unknown_backend_raises(pair, name,
                                                          monkeypatch):
    """The full-tile path runs on the CPU through its entry points:
    optimize_pose(backend="fused", subtile=False) and
    render_depth_gt(backend="fused") reach build_slot_buffer and
    render_tracking_depth and give finite results; an unknown backend is
    a ValueError."""
    from gsplatloc_tpu_torch.ops import fused_tracking

    calls = {"build_slot_buffer": 0, "render_tracking_depth": 0}
    for fn_name in calls:
        fn = getattr(fused_tracking, fn_name)

        def wrapped(*a, _fn=fn, _name=fn_name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(fused_tracking, fn_name, wrapped)

    def opt(**kw):
        return optimize_pose(pair["scene_t"], np.eye(4, dtype=np.float32),
                             pair["depth_gt"], pair["K"], W, H,
                             device="cpu", **kw)

    if name == "unknown_backend":
        with pytest.raises(ValueError, match="backend"):
            opt(backend="gsplat")
        return
    if name == "subtile_false":
        res = opt(config=TrackingConfig(subtile=False, max_steps=3,
                                         warmup_steps=0),
                  backend="fused")
        assert res.steps_run == 3 and res.selects == 0
        assert bool(torch.isfinite(res.best_loss))
    else:
        pts = np.random.default_rng(0).random((16 * 16, 3)).astype(np.float32)
        pts[:, 2] += 1.0
        d = tparser.render_depth_gt(pts, pts, pair["K"], np.eye(4), 16, 16,
                                    backend="fused", device="cpu")
        assert tuple(d.shape) == (16, 16) and bool(torch.isfinite(d).all())
    assert calls["build_slot_buffer"] >= 1
    assert calls["render_tracking_depth"] >= 1


def test_general_path_takes_the_plain_versions_on_the_cpu(pair):
    """Through the whole step (projection, binning, gather, composite and
    its backward), a CPU run launches no kernel and builds nothing; the
    gradient reaches the pose."""
    from gsplatloc_tpu_torch.models.pose import PoseState
    from gsplatloc_tpu_torch.ops.lie import invert_se3 as t_invert
    from gsplatloc_tpu_torch.ops.rasterize import rasterize

    kernels.reset_launch_counts()
    s = pair["scene_t"]
    trans = torch.tensor([0.01, 0.0, 0.0], requires_grad=True)
    vm = t_invert(PoseState(torch.tensor([1.0, 0, 0, 0]), trans).to_c2w())
    r, _ = rasterize(s.means, s.quats, s.scales, s.opacities, s.sh_coeffs,
                     vm, torch.as_tensor(pair["K"]), W, H,
                     render_mode="RGB+ED", backend="pallas")
    (g,) = torch.autograd.grad(r[..., 3].sum(), trans)
    assert float(g.abs().max()) > 0
    assert all(v == 0 for v in kernels.launch_counts().values())
    assert kernels._lib is None
