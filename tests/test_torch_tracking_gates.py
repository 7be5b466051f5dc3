"""The port's two-gate tracking loop on the CPU: pose recovery through the
K-cover render, coast mode and early stopping, with the reference tests'
own bars (tests/test_kcover.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsplatloc_tpu.ops.fused_subtile import (
    build_subtile_slot_buffer, render_tracking_depth_subtile,
)
from gsplatloc_tpu.ops.lie import invert_se3
from gsplatloc_tpu_torch.opt.tracking import TrackingConfig, optimize_pose
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


def test_optimize_pose_kcover_backend(pair):
    """The two-gate loop recovers a perturbed pose through the K-cover
    render (the reference test's own bars)."""
    cfg = TrackingConfig(max_steps=200, patience=50, warmup_steps=30,
                         resort_every=10, kcover=16)
    res = _run_port(pair, cfg)
    e_t, e_r = _errors(res, pair["gt"])
    e_t0 = float(np.linalg.norm(pair["gt"][:3, 3]))
    assert e_t < e_t0 / 20, (e_t, e_t0)
    assert e_r < 0.1
    assert float(res.best_loss) < 2e-3
    assert res.selects >= 1
    assert res.steps_run <= 200


def test_kcover_coast_mode_regression(pair):
    """Coast mode (gates loosen 8x after coast_after_steps non-improving
    steps) must not degrade the recovered pose: the same recovery with
    coast engaged EARLY (trigger 5) vs disabled reaches the same class,
    and coasting never fires MORE rebuilds or selects."""
    results = {}
    for label, coast in (("coast", 5), ("no_coast", 0)):
        cfg = TrackingConfig(max_steps=200, patience=50, warmup_steps=30,
                             resort_every=10, kcover=16,
                             coast_after_steps=coast)
        results[label] = _run_port(pair, cfg)
    e = {k: _errors(v, pair["gt"])[0] for k, v in results.items()}
    e_t0 = float(np.linalg.norm(pair["gt"][:3, 3]))
    assert e["no_coast"] < e_t0 / 20, e
    assert e["coast"] < max(e["no_coast"] * 2.0, e_t0 / 20), e
    assert results["coast"].selects <= results["no_coast"].selects
    assert results["coast"].rebuilds <= results["no_coast"].rebuilds


def test_early_stop_ends_the_loop_at_patience(pair):
    """With a tiny patience the loop stops early; with early_stop off it
    runs max_steps. The best pose is taken after the warm-up only."""
    kw = dict(max_steps=80, patience=3, warmup_steps=5, resort_every=10)
    res = _run_port(pair, TrackingConfig(**kw))
    assert 9 <= res.steps_run < 80
    full = _run_port(pair, TrackingConfig(early_stop=False, **kw))
    assert full.steps_run == 80
    assert float(full.best_loss) <= float(res.best_loss)
