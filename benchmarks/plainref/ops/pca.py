"""PCA scene normalization (PyTorch).

Median-centred covariance eigendecomposition -> SE(3) aligning principal
axes to coordinate axes; applied to both frames' world points and poses,
extracting the scale factor used to rescale rendered depth.
"""

from __future__ import annotations

import torch

from .lie import transform_points


def align_principal_axes(points: torch.Tensor) -> torch.Tensor:
    """(N, 3) points -> (4, 4) SE(3) whose rotation aligns principal axes:
    centroid = per-axis LOWER median (the lower middle element for even N),
    covariance of the centred cloud with the unbiased (N-1) normalization,
    eigh, eigenvectors sorted by descending eigenvalue, determinant sign fix
    on the first eigenvector, R = V^T, t = -R @ centroid.

    The 3x3 eigh runs on the HOST: eigenvector signs are then the same
    whichever device holds the cloud (a once-per-pair 36-byte transfer)."""
    n_pts = points.shape[0]
    centroid = torch.sort(points, dim=0).values[(n_pts - 1) // 2]
    centered = points - centroid
    cov = (centered.T @ centered) / (n_pts - 1)
    eigvals, eigvecs = torch.linalg.eigh(cov.cpu())
    order = torch.argsort(-eigvals)
    eigvecs = eigvecs[:, order]
    det = torch.linalg.det(eigvecs)
    eigvecs = eigvecs.clone()
    eigvecs[:, 0] = eigvecs[:, 0] * torch.where(det < 0, -1.0, 1.0)
    R = eigvecs.T.to(points.device)
    T = torch.eye(4, dtype=points.dtype, device=points.device)
    T[:3, :3] = R
    T[:3, 3] = -(R @ centroid)
    return T


def transform_cameras(matrix: torch.Tensor, c2w: torch.Tensor):
    """Apply (4,4) SE(3) to a (B,4,4) c2w stack; returns (new_c2w,
    scale (B,1)): left-multiply, then re-normalize the rotation block by
    the norm of the transformed first row."""
    transformed = torch.einsum("ki,nij->nkj", matrix, c2w)
    scaling = torch.linalg.norm(transformed[:, 0, :3], dim=1, keepdim=True)
    rot = transformed[:, :3, :3] / scaling[..., None]
    transformed = transformed.clone()
    transformed[:, :3, :3] = rot
    return transformed, scaling


def normalize_pair(tar_points, src_points, tar_pose, src_pose):
    """Normalize a (tar, src) world-frame pair by tar's principal axes.
    Returns (tar_points', src_points', tar_pose', src_pose', pca_factor)."""
    T = align_principal_axes(tar_points)
    tar_points = transform_points(T, tar_points)
    src_points = transform_points(T, src_points)
    new_tar, scale = transform_cameras(T, tar_pose[None])
    new_src, _ = transform_cameras(T, src_pose[None])
    return tar_points, src_points, new_tar[0], new_src[0], scale[0, 0]
