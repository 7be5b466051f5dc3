"""The slice as a whole: optimize_pose of the port and of the reference
from the same frame pair on the CPU (the port through its plain PyTorch
versions, the reference through its plain-XLA step and its interpreted
Pallas select)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplatloc_tpu.ops.fused_subtile import (
    build_subtile_slot_buffer, render_tracking_depth_subtile,
)
from gsplatloc_tpu.ops.lie import invert_se3
from gsplatloc_tpu.opt.tracking import TrackingConfig as JConfig
from gsplatloc_tpu.opt.tracking import optimize_pose as j_optimize_pose
from gsplatloc_tpu_torch.convert import (
    adam_from_numpy, config_from_reference, pose_from_numpy,
)
from gsplatloc_tpu_torch.opt.tracking import (
    PairResult, TrackingConfig, optimize_pose,
)
from torch_port_helpers import box_scene, perturbed_c2w, to_np

H, W = 48, 128


@pytest.fixture(scope="module")
def pair():
    scene_j, scene_t, K = box_scene(H, W, clutter=10)
    gt = perturbed_c2w((0.7, -0.4, 0.3), (0.012, -0.01, 0.018))
    vm = invert_se3(jnp.asarray(gt))
    slot, meta, _ = build_subtile_slot_buffer(scene_j, vm, jnp.asarray(K),
                                              W, H, 1e-2, 1e10)
    depth_gt, _ = render_tracking_depth_subtile(vm, jnp.asarray(K), W, H,
                                                slot, meta)
    return dict(scene_j=scene_j, scene_t=scene_t, K=K, gt=gt,
                depth_gt=np.asarray(jax.lax.stop_gradient(depth_gt)))


def _errors(res, gt):
    best = to_np(res.best_pose.to_c2w()).astype(np.float64)
    e_t = float(np.linalg.norm(best[:3, 3] - gt[:3, 3]))
    cos = (np.trace(best[:3, :3] @ gt[:3, :3].T.astype(np.float64)) - 1) / 2
    return e_t, float(np.degrees(np.arccos(np.clip(cos, -1, 1))))


def _run_port(pair, cfg):
    return optimize_pose(pair["scene_t"], np.eye(4, dtype=np.float32),
                         pair["depth_gt"], pair["K"], W, H, config=cfg,
                         backend="fused", device="cpu")


def test_optimize_pose_matches_reference(pair):
    """60 steps with a short warm-up: equal steps_run, rebuilds and selects
    (every gate decision falls the same way), best pose within 1e-4 (the
    two step renders differ by f32 contraction; Adam's normalized update
    keeps that from growing), best loss within 2 %."""
    kw = dict(max_steps=60, patience=50, warmup_steps=10, resort_every=10)
    cfg_j = JConfig(**kw)
    rj = j_optimize_pose(pair["scene_j"], jnp.eye(4),
                         jnp.asarray(pair["depth_gt"]),
                         jnp.asarray(pair["K"]), W, H, config=cfg_j,
                         backend="fused")
    rt = _run_port(pair, config_from_reference(cfg_j))
    assert isinstance(rt, PairResult)
    assert rt.steps_run == int(rj.steps_run) == 60
    assert rt.rebuilds == int(rj.rebuilds)
    assert rt.selects == int(rj.selects) >= 1
    assert rt.slot_overflow == bool(rj.slot_overflow) is False
    for f in ("best_pose", "final_pose"):
        np.testing.assert_allclose(to_np(getattr(rt, f).quat),
                                   to_np(getattr(rj, f).quat), atol=1e-4)
        np.testing.assert_allclose(to_np(getattr(rt, f).trans),
                                   to_np(getattr(rj, f).trans), atol=1e-4)
    np.testing.assert_allclose(float(rt.best_loss), float(rj.best_loss),
                               rtol=2e-2)
    np.testing.assert_allclose(float(rt.best_depth_loss),
                               float(rj.best_depth_loss), rtol=2e-2)
    # and both moved towards the true pose
    e_t0 = float(np.linalg.norm(pair["gt"][:3, 3]))
    assert _errors(rt, pair["gt"])[0] < e_t0 / 2


@pytest.mark.parametrize("budget,expect", [(0.05, True), (1.0, False)])
def test_kcover_overflow_surfaces_in_pair_result(pair, budget, expect):
    cfg = TrackingConfig(max_steps=3, patience=10, warmup_steps=0,
                         resort_every=2, kcover=16, slot_budget=budget)
    res = _run_port(pair, cfg)
    assert res.slot_overflow is expect
    assert res.steps_run == 3


def test_zero_motion_pair_fires_no_gate(pair):
    """Target rendered at the init pose: nothing moves past a gate."""
    vm = jnp.eye(4)
    slot, meta, _ = build_subtile_slot_buffer(
        pair["scene_j"], vm, jnp.asarray(pair["K"]), W, H, 1e-2, 1e10)
    d0, _ = render_tracking_depth_subtile(vm, jnp.asarray(pair["K"]), W, H,
                                          slot, meta)
    cfg = TrackingConfig(max_steps=20, warmup_steps=2, resort_every=5)
    res = optimize_pose(pair["scene_t"], np.eye(4, dtype=np.float32),
                        np.asarray(d0), pair["K"], W, H, config=cfg,
                        device="cpu")
    assert (res.steps_run, res.rebuilds) == (20, 0)
    assert _errors(res, np.eye(4, dtype=np.float32))[0] < 2e-3


@pytest.fixture(scope="module")
def cloud_pair():
    """The reference's sub-tile tracking tests' scene (1200 random splats of
    scale 0.06 at 48x128) and its depth target at the true pose."""
    from gsplatloc_tpu.data.synthetic import random_gaussian_cloud
    from gsplatloc_tpu.models.gaussians import scene_from_point_cloud
    from gsplatloc_tpu_torch.convert import scene_from_numpy

    rng = np.random.default_rng(9)
    pts, rgb = random_gaussian_cloud(rng, 1200)
    scene_j = scene_from_point_cloud(jnp.asarray(pts), jnp.asarray(rgb))
    scene_j = scene_j._replace(scales=jnp.full_like(scene_j.scales, 0.06))
    scene_t = scene_from_numpy(
        {k: np.asarray(getattr(scene_j, k)) for k in scene_j._fields},
        device="cpu")
    K = np.array([[70.0, 0, W / 2 - 0.5], [0, 70.0, H / 2 - 0.5], [0, 0, 1]],
                 np.float32)
    gt = perturbed_c2w((0.7, -0.4, 0.3), (0.012, -0.01, 0.018))
    vm = invert_se3(jnp.asarray(gt))
    slot, meta, _ = build_subtile_slot_buffer(scene_j, vm, jnp.asarray(K),
                                              W, H, 1e-2, 1e10)
    depth_gt, _ = render_tracking_depth_subtile(vm, jnp.asarray(K), W, H,
                                                slot, meta)
    return dict(scene_j=scene_j, scene_t=scene_t, K=K, gt=gt,
                depth_gt=np.asarray(jax.lax.stop_gradient(depth_gt)))


@pytest.mark.parametrize("kw", [
    dict(resort_every=25),  # tests/test_fused_subtile.py subtile backend
    dict(resort_every=10, resort_motion_px=0.25),  # motion-adaptive resort
], ids=["subtile_backend", "motion_adaptive_resort"])
def test_optimize_pose_kcover0_matches_reference(cloud_pair, kw):
    """The sub-tile path (kcover=0) of both packages, 60 steps (the
    reference tests run 200; cut for the CPU): equal steps_run and
    rebuilds, no select and no overflow, best and final pose within 5e-5
    and best loss within 1.5 % (measured 3.5e-5 and 1.1 % with the
    motion-adaptive resort: the two backward walks sum the moments in other
    orders and Adam carries that difference along), and the reference
    tests' recovery bars."""
    cfg_j = JConfig(max_steps=60, patience=50, warmup_steps=30, kcover=0,
                    subtile=True, **kw)
    p = cloud_pair
    rj = j_optimize_pose(p["scene_j"], jnp.eye(4), jnp.asarray(p["depth_gt"]),
                         jnp.asarray(p["K"]), W, H, config=cfg_j,
                         backend="fused")
    rt = optimize_pose(p["scene_t"], np.eye(4, dtype=np.float32),
                       p["depth_gt"], p["K"], W, H,
                       config=config_from_reference(cfg_j), backend="fused",
                       device="cpu")
    assert rt.steps_run == int(rj.steps_run) == 60
    assert rt.rebuilds == int(rj.rebuilds)
    assert rt.selects == int(rj.selects) == 0
    assert rt.slot_overflow is False and bool(rj.slot_overflow) is False
    for f in ("best_pose", "final_pose"):
        np.testing.assert_allclose(to_np(getattr(rt, f).quat),
                                   to_np(getattr(rj, f).quat), atol=5e-5)
        np.testing.assert_allclose(to_np(getattr(rt, f).trans),
                                   to_np(getattr(rj, f).trans), atol=5e-5)
    np.testing.assert_allclose(float(rt.best_loss), float(rj.best_loss),
                               rtol=1.5e-2)
    e_t, e_r = _errors(rt, p["gt"])
    assert e_t < float(np.linalg.norm(p["gt"][:3, 3])) / 5
    assert e_r < 0.3


def _unported(name, pair):
    from gsplatloc_tpu_torch import cli
    from gsplatloc_tpu_torch.tracking.runner import SequenceRunner

    def opt(**kw):
        args = dict(config=TrackingConfig(), backend="fused")
        args.update(kw)
        return optimize_pose(pair["scene_t"], np.eye(4, dtype=np.float32),
                             pair["depth_gt"], pair["K"], W, H,
                             device="cpu", **args)

    return {
        "pallas": lambda: opt(backend="pallas"),
        "subtile_false": lambda: opt(config=TrackingConfig(subtile=False)),
        "cli_icp": lambda: cli.main(["icp", "--dataset", "Synthetic"]),
        "cli_render": lambda: cli.main(["render", "--dataset", "Synthetic"]),
        "panel_every": lambda: SequenceRunner(
            "Synthetic", "", panel_every=1, device="cpu", knn_method="grid",
            n_frames=3, height=16, width=16),
    }[name]


@pytest.mark.parametrize("name", ["pallas", "subtile_false", "cli_icp",
                                  "cli_render", "panel_every"])
def test_unported_paths_raise(pair, name):
    """The general rasterizer, the full-tile path, the baselines, the
    render fly-through and the runner's panels are later slices."""
    with pytest.raises(NotImplementedError, match="not ported|ported"):
        _unported(name, pair)()


def test_state_conversion_round_trip(pair):
    sj, st = pair["scene_j"], pair["scene_t"]
    for f in sj._fields:
        np.testing.assert_array_equal(to_np(getattr(st, f)),
                                      np.asarray(getattr(sj, f)))
    p = pose_from_numpy([1, 0, 0, 0], [0.1, 0.2, 0.3], device="cpu")
    assert p.quat.dtype == torch.float32 and tuple(p.trans.shape) == (3,)
    a = adam_from_numpy(np.zeros(4), np.ones(4), device="cpu")
    assert a.m.dtype == a.v.dtype == torch.float32 and float(a.v.sum()) == 4
    with pytest.raises(ValueError):
        config_from_reference({"max_steps": 5, "not_a_field": 1})
    assert config_from_reference({"max_steps": 5}).max_steps == 5
