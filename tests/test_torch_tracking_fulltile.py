"""The full-tile path as a whole on the CPU: optimize_pose(backend="fused",
TrackingConfig(subtile=False)) of the port, with and without compaction,
against the reference's optimize_pose with the same configuration from the
same frame pair (the reference runs its full-tile Pallas kernels in
interpret mode). `subtile=False` is set explicitly: the reference's own
end-to-end test of this backend leaves subtile=True."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from gsplatloc_tpu.data.synthetic import random_gaussian_cloud
from gsplatloc_tpu.models.gaussians import scene_from_point_cloud
from gsplatloc_tpu.ops import camera
from gsplatloc_tpu.ops import fused_tracking as jft
from gsplatloc_tpu.ops.lie import invert_se3
from gsplatloc_tpu.opt.tracking import TrackingConfig as JConfig
from gsplatloc_tpu.opt.tracking import optimize_pose as j_optimize_pose
from gsplatloc_tpu_torch import kernels
from gsplatloc_tpu_torch.convert import config_from_reference, scene_from_numpy
from gsplatloc_tpu_torch.opt.tracking import optimize_pose
from torch_port_helpers import to_np

H, W = 48, 128


@pytest.fixture(scope="module")
def pair():
    """800 random splats (scale 0.06, opacity 1); the depth target is the
    reference's full-tile render at a pose displaced by ~0.9 deg / 2.4 cm
    from identity, the initial pose."""
    rng = np.random.default_rng(9)
    pts, rgb = random_gaussian_cloud(rng, 800)
    scene_j = scene_from_point_cloud(jnp.asarray(pts), jnp.asarray(rgb))
    scene_j = scene_j._replace(scales=jnp.full_like(scene_j.scales, 0.06))
    scene_t = scene_from_numpy(
        {k: np.asarray(getattr(scene_j, k)) for k in scene_j._fields},
        device="cpu")
    K = np.array(camera.intrinsics_matrix(70.0, 70.0, W / 2 - 0.5,
                                          H / 2 - 0.5))
    gt = np.eye(4, dtype=np.float32)
    gt[:3, :3] = Rotation.from_euler("xyz", [0.7, -0.4, 0.3],
                                     degrees=True).as_matrix()
    gt[:3, 3] = [0.012, -0.01, 0.018]
    vm = invert_se3(jnp.asarray(gt))
    slot, meta, _ = jft.build_slot_buffer(scene_j, vm, jnp.asarray(K), W, H,
                                          1e-2, 1e10)
    depth_gt, _ = jft.render_tracking_depth(vm, jnp.asarray(K), W, H, slot,
                                            meta)
    return dict(scene_j=scene_j, scene_t=scene_t, K=K, gt=gt,
                depth_gt=np.asarray(jax.lax.stop_gradient(depth_gt)))


@pytest.mark.parametrize("compact", [False, True])
def test_optimize_pose_fulltile_matches_reference(pair, compact):
    """60 steps, a rebuild gate of 1 px: equal steps_run and rebuilds (2:
    every gate decision falls the same way), best and final pose within
    1e-4 and best loss within 5 % (measured 5e-5 and 4 % with compaction:
    the reference's backward expands its sums into moments, which round
    differently, and Adam carries that along 60 steps near the loss
    floor), the pose recovered (eT below a fifth of the initial error, eR
    below 0.3 deg); on the CPU no kernel is launched."""
    cfg = JConfig(max_steps=60, patience=50, warmup_steps=10,
                  resort_every=10, resort_motion_px=1.0, subtile=False,
                  compact=compact)
    rj = j_optimize_pose(pair["scene_j"], jnp.eye(4),
                         jnp.asarray(pair["depth_gt"]),
                         jnp.asarray(pair["K"]), W, H, config=cfg,
                         backend="fused")
    kernels.reset_launch_counts()
    rt = optimize_pose(pair["scene_t"], np.eye(4, dtype=np.float32),
                       pair["depth_gt"], pair["K"], W, H,
                       config=config_from_reference(cfg), backend="fused",
                       device="cpu")
    assert all(v == 0 for v in kernels.launch_counts().values())
    assert rt.steps_run == int(rj.steps_run) == 60
    assert rt.rebuilds == int(rj.rebuilds) >= 2
    assert rt.selects == int(rj.selects) == 0
    assert rt.slot_overflow is False
    for f in ("best_pose", "final_pose"):
        np.testing.assert_allclose(to_np(getattr(rt, f).quat),
                                   np.asarray(getattr(rj, f).quat), atol=1e-4)
        np.testing.assert_allclose(to_np(getattr(rt, f).trans),
                                   np.asarray(getattr(rj, f).trans), atol=1e-4)
    np.testing.assert_allclose(float(rt.best_loss), float(rj.best_loss),
                               rtol=5e-2)
    best = to_np(rt.best_pose.to_c2w()).astype(np.float64)
    gt = pair["gt"].astype(np.float64)
    e_t = float(np.linalg.norm(best[:3, 3] - gt[:3, 3]))
    cos = (np.trace(best[:3, :3] @ gt[:3, :3].T) - 1.0) / 2.0
    e_r = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
    assert e_t < float(np.linalg.norm(gt[:3, 3])) / 5, e_t
    assert e_r < 0.3, e_r
