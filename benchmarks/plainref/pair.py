"""One frame pair tracked by the plain reference, from two decoded depth
frames to the best pose.

The steps are those of the port's `SequenceRunner` on the K-cover path
(`data/parser.py:_assemble_pair`, `render_depth_gt` with the sub-tile
backend, `models/gaussians.py:scene_from_point_cloud` with exact kNN
scales, `opt/tracking.py:optimize_pose`), frozen here in their plain
PyTorch forms. Colour is left out: it reaches only the scene's SH
coefficients, which the depth render and the depth-only loss never read.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import as_f32
from .models.gaussians import scene_from_point_cloud
from .ops.camera import depth_to_points
from .ops.knn import exact_knn_sq_dists
from .ops.lie import invert_se3, transform_points
from .ops.pca import normalize_pair
from .opt.tracking import TrackingConfig, optimize_pose


def camera_cloud(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """(H*W, 3) float32 camera-frame cloud of a depth image, as the host
    kNN reads it."""
    depth = np.asarray(depth, np.float32)
    K = np.asarray(K, np.float32)
    h, w = depth.shape
    u = np.arange(w, dtype=np.float32)[None, :]
    v = np.arange(h, dtype=np.float32)[:, None]
    x = (u - K[0, 2]) / K[0, 0] * depth
    y = (v - K[1, 2]) / K[1, 1] * depth
    return np.stack([x, y, depth], axis=-1).reshape(-1, 3)


def render_depth_gt(points, K, c2w, height, width, knn_sq_dists, device):
    """The pair's depth target: the src cloud as opacity-1 Gaussians with
    kNN scales, rendered to depth from tar's pose through the sub-tile
    walk (K4a/K4b's plain forms)."""
    from .ops.fused_subtile import (
        build_subtile_slot_buffer,
        render_tracking_depth_subtile,
    )

    with torch.no_grad():
        scene = scene_from_point_cloud(
            points, torch.zeros_like(points), grid_shape=(height, width),
            knn_sq_dists=knn_sq_dists, device=device)
        vm = invert_se3(as_f32(c2w, device))
        slot, meta, _ = build_subtile_slot_buffer(
            scene, vm, as_f32(K, device), width, height, 1e-2, 1e10)
        depth, _alpha = render_tracking_depth_subtile(
            vm, as_f32(K, device), width, height, slot, meta)
    return depth


def track_pair(tar_depth, tar_c2w, src_depth, src_c2w, K,
               config: TrackingConfig, device) -> dict:
    """Track src against tar. Depths (H, W) in metres as float64 arrays,
    poses (4, 4), K (3, 3). Returns the pair's best pose in its normalized
    frame (float64 (4, 4)) and its steps run and selects."""
    dev = torch.device(device)
    h, w = src_depth.shape
    knn_tar = exact_knn_sq_dists(camera_cloud(tar_depth, K), 5)
    knn_src = exact_knn_sq_dists(camera_cloud(src_depth, K), 5)
    Kt = as_f32(K, dev)
    with torch.no_grad():
        td, tc, sd, sc = (as_f32(a, dev) for a in
                          (tar_depth, tar_c2w, src_depth, src_c2w))
        tar_points = transform_points(tc, depth_to_points(td, Kt))
        src_points = transform_points(tc, depth_to_points(sd, Kt))
        tar_points, src_points, tar_n, _src_n, pca_factor = normalize_pair(
            tar_points, src_points, tc, sc)
        depth_gt = render_depth_gt(src_points, Kt, tar_n, h, w, knn_src,
                                   dev) / pca_factor
        scene = scene_from_point_cloud(
            tar_points, torch.zeros_like(tar_points), grid_shape=(h, w),
            knn_sq_dists=knn_tar, knn_method="exact", device=dev)
    out = optimize_pose(scene, tar_n, depth_gt, Kt, w, h, config=config,
                        device=dev)
    return dict(best_c2w=out.best_pose.to_c2w().double().cpu().numpy(),
                steps=int(out.steps_run), selects=int(out.selects))
