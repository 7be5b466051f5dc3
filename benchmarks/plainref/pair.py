"""The prepare of one frame pair that every tracking path shares, from two
decoded depth frames to the scene and the depth target, and the result a
path's `track_pair` returns.

The steps are those of the port's `SequenceRunner` (`data/parser.py:
_assemble_pair`, `render_depth_gt`, `models/gaussians.py:
scene_from_point_cloud` with exact kNN scales), frozen here in their plain
PyTorch forms; the depth target's render is the path's own (the port
renders it through the path's kernel family), passed in by the path
module (`plainref/paths/<path>.py`). Colour is left out: it reaches only
the scene's SH coefficients, which the depth render and the depth-only
loss never read.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import as_f32
from .models.gaussians import scene_from_point_cloud
from .ops.camera import depth_to_points
from .ops.knn import exact_knn_sq_dists
from .ops.lie import transform_points
from .ops.pca import normalize_pair


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


def prepare(tar_depth, tar_c2w, src_depth, src_c2w, K, depth_target,
            device) -> tuple:
    """(scene, tar's normalized pose, depth target, K, width, height) of
    the pair: exact kNN scales over both clouds, back-projection, PCA
    normalisation, the depth target `depth_target(src_points, K, tar_c2w,
    height, width, knn_sq_dists, device)` in the normalized frame, and
    tar's scene. Depths (H, W) in metres as float64 arrays, poses (4, 4),
    K (3, 3)."""
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
        depth_gt = depth_target(src_points, Kt, tar_n, h, w, knn_src,
                                dev) / pca_factor
        scene = scene_from_point_cloud(
            tar_points, torch.zeros_like(tar_points), grid_shape=(h, w),
            knn_sq_dists=knn_tar, knn_method="exact", device=dev)
    return scene, tar_n, depth_gt, Kt, w, h


def result(out) -> dict:
    """What a path's `track_pair` returns of its loop's PairResult: the
    best pose in the pair's normalized frame (float64 (4, 4)), the steps
    run and the selects."""
    return dict(best_c2w=out.best_pose.to_c2w().double().cpu().numpy(),
                steps=int(out.steps_run), selects=int(out.selects))
