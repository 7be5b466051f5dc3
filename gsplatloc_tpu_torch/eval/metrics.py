"""Pose / trajectory error metrics.

Translation error, the geodesic rotation error (host float64), the RMSE
reduction used for ATE/AAE over a sequence, point-cloud RMSE, centre-of-mass
distance, the Sobel silhouette difference, and the seeding of the host
random generators.
"""

from __future__ import annotations

import numpy as np
import torch


def translation_error(est_pose, true_pose) -> torch.Tensor:
    """||t_est - t_true||_2 for (..., 4, 4) poses (tensors or arrays)."""
    est = torch.as_tensor(est_pose)
    true = torch.as_tensor(true_pose, device=est.device)
    return torch.linalg.norm(est[..., :3, 3] - true[..., :3, 3], dim=-1)


def rotation_error_deg(est_pose, true_pose) -> np.ndarray:
    """Geodesic rotation error in degrees: acos((tr(R_est R_true^T)-1)/2).

    Computed on the host in float64: acos near 1 has a sqrt(eps) noise
    floor, so a float32 version cannot resolve below ~0.026 deg."""
    R_est = _host64(est_pose)[..., :3, :3]
    R_true = _host64(true_pose)[..., :3, :3]
    delta = np.einsum("...ij,...kj->...ik", R_est, R_true)
    tr = np.trace(delta, axis1=-2, axis2=-1)
    cos = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(cos))


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def rmse(values) -> float:
    """sqrt(mean(x^2)) — the reduction used for ATE/AAE RMSE."""
    v = np.asarray(values, dtype=np.float64)
    return float(np.sqrt(np.mean(v**2))) if v.size else float("nan")


def pointcloud_rmse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-point RMSE between equally sized (N, 3) clouds."""
    return torch.sqrt(torch.mean(torch.sum((a - b) ** 2, dim=-1)))


def com_difference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance between the centres of mass of two (N, 3) clouds."""
    return torch.linalg.norm(torch.mean(a, dim=0) - torch.mean(b, dim=0))


def silhouette_diff(depth_a: torch.Tensor, depth_b: torch.Tensor) -> torch.Tensor:
    """Absolute Sobel-edge difference image of two (H, W) depth maps."""
    from ..ops.filters import sobel_magnitude

    return torch.abs(sobel_magnitude(depth_a) - sobel_magnitude(depth_b))


def set_random_seed(seed: int = 42):
    """Seed the host random generators: python, numpy and torch."""
    import random

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
