"""Frozen Gaussian scene construction from an RGB-D point cloud.

means = points, opacity 1.0 (init_opa), isotropic scales from kNN
distances (with the squared-distance quirk, see ops/knn.py), identity
quaternions, SH degree 1 with DC = rgb_to_sh and zero higher bands. The
scene is FROZEN — only the camera pose is optimized.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import DEFAULT_DEVICE, as_f32, resolve_device
from ..ops.knn import exact_knn_sq_dists, init_gs_scales_from_sq_dists
from ..ops.sh import rgb_to_sh


class GaussianScene(NamedTuple):
    """Frozen splat scene."""

    means: torch.Tensor  # (N, 3)
    quats: torch.Tensor  # (N, 4) wxyz
    scales: torch.Tensor  # (N, 3)
    opacities: torch.Tensor  # (N,)
    sh_coeffs: torch.Tensor  # (N, (deg+1)^2, 3)

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]


def scene_from_point_cloud(
    points,  # (N, 3)
    rgbs,  # (N, 3) in [0, 1]
    *,
    knn_sq_dists=None,  # (N, k) precomputed
    grid_shape: tuple[int, int] | None = None,  # (H, W) if grid-ordered cloud
    sh_degree: int = 1,
    init_opa: float = 1.0,
    knn_k: int = 5,
    knn_window: int = 2,
    knn_method: str = "auto",
    device=DEFAULT_DEVICE,
) -> GaussianScene:
    """Build the frozen scene on `device` with scales from precomputed kNN
    squared distances, or (knn_method "exact") the exact kNN of the
    points. The port's grid-window and brute-force methods are not on the
    benchmark's path (its configurations use exact kNN)."""
    dev = resolve_device(device)
    if knn_sq_dists is None and knn_method == "exact":
        knn_sq_dists = exact_knn_sq_dists(points, knn_k)
    points = as_f32(points, dev)
    rgbs = as_f32(rgbs, dev)
    n = points.shape[0]
    if knn_sq_dists is None:
        raise ValueError("pass knn_sq_dists or knn_method='exact'")
    knn_sq_dists = as_f32(knn_sq_dists, dev)
    scales = init_gs_scales_from_sq_dists(knn_sq_dists)

    quats = torch.zeros((n, 4), dtype=points.dtype, device=dev)
    quats[:, 0] = 1.0
    opacities = torch.full((n,), float(init_opa), dtype=points.dtype,
                           device=dev)

    k_sh = (sh_degree + 1) ** 2
    sh = torch.zeros((n, k_sh, 3), dtype=points.dtype, device=dev)
    sh[:, 0, :] = rgb_to_sh(rgbs)
    return GaussianScene(
        means=points, quats=quats, scales=scales, opacities=opacities,
        sh_coeffs=sh,
    )
