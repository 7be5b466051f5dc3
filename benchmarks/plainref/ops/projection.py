"""3D Gaussian -> 2D screen-space projection (PyTorch, differentiable).

EWA splatting, classic mode: world->camera transform of the means,
perspective projection, Sigma_2D = J W Sigma W^T J^T with the FoV-limited
Jacobian J, 0.3-pixel dilation of the 2D covariance, conic, screen radius
and visibility culling. Culling quantities (radius, valid) are integer /
boolean and carry no gradient.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# Radius multiplier covering the full ALPHA_MIN=1/255 contribution reach of
# an opacity-1 splat: alpha = exp(-sigma) >= 1/255  <=>  r <= sqrt(2 ln 255).
ALPHA_REACH = math.sqrt(2.0 * math.log(255.0))


class ProjectedGaussians(NamedTuple):
    """Screen-space Gaussians for one camera."""

    mean2d: torch.Tensor  # (N, 2) pixel coords
    conic: torch.Tensor | None  # (N, 3) inverse 2D covariance (a, b, c)
    depth: torch.Tensor  # (N,) camera-frame z
    radius: torch.Tensor  # (N,) int32 pixel radius (0 = culled)
    valid: torch.Tensor  # (N,) bool
    opacity_comp: torch.Tensor | None = None  # (N,) antialiased compensation


def _radius_and_valid(a, c, det, z, mean2d, width, height, near_plane,
                      far_plane, radius_clip):
    bmid = 0.5 * (a + c)
    v1 = bmid + torch.sqrt((bmid * bmid - det).clamp_min(0.01))
    radius_f = torch.ceil(ALPHA_REACH * torch.sqrt(v1.clamp_min(0.0)))
    valid = (
        (z > near_plane)
        & (z < far_plane)
        & (det > 0.0)
        & (radius_f > radius_clip)
        & (mean2d[:, 0] + radius_f > 0)
        & (mean2d[:, 0] - radius_f < width)
        & (mean2d[:, 1] + radius_f > 0)
        & (mean2d[:, 1] - radius_f < height)
    )
    radius = torch.where(valid, radius_f, 0.0).detach().to(torch.int32)
    return radius, valid


def _camera_terms(means, viewmat, K, width, height):
    R_cw = viewmat[:3, :3]
    t_cw = viewmat[:3, 3]
    p_cam = means @ R_cw.T + t_cw  # (N, 3)
    x, y, z = p_cam[:, 0], p_cam[:, 1], p_cam[:, 2]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    zs = torch.where(z.abs() < 1e-8, 1e-8, z)  # guard divisions
    mean2d = torch.stack([fx * x / zs + cx, fy * y / zs + cy], dim=-1)
    return R_cw, x, y, z, zs, fx, fy, mean2d


def project_iso_binning(
    means: torch.Tensor,  # (N, 3) world
    s2: torch.Tensor,  # (N,) isotropic world VARIANCE (scale^2)
    viewmat: torch.Tensor,  # (4, 4) world->camera
    K: torch.Tensor,  # (3, 3)
    width: int,
    height: int,
    near_plane: float = 1e-2,
    far_plane: float = 1e10,
    eps2d: float = 0.3,
) -> ProjectedGaussians:
    """Binning-facing projection for ISOTROPIC scenes (identity quats, s*I
    scales): cov_cam = s2*I, so cov2d = s2*(J J^T) + eps2d*I in elementwise
    scalar algebra — the same folding `_project_parts` uses. Returns
    mean2d/depth/radius/valid only (conic=None — binning does not read
    it)."""
    _R, x, y, z, zs, fx, fy, mean2d = _camera_terms(
        means, viewmat, K, width, height)

    lim_x = 1.3 * 0.5 * width / fx
    lim_y = 1.3 * 0.5 * height / fy
    tx = zs * torch.minimum(torch.maximum(x / zs, -lim_x), lim_x)
    ty = zs * torch.minimum(torch.maximum(y / zs, -lim_y), lim_y)
    rz = 1.0 / zs
    rz2 = rz * rz
    j00 = fx * rz
    j02 = -fx * tx * rz2
    j11 = fy * rz
    j12 = -fy * ty * rz2

    a = s2 * (j00 * j00 + j02 * j02) + eps2d
    b = s2 * (j02 * j12)
    c = s2 * (j11 * j11 + j12 * j12) + eps2d
    det = a * c - b * b

    radius, valid = _radius_and_valid(
        a, c, det, z, mean2d, width, height, near_plane, far_plane, 0.0)
    return ProjectedGaussians(
        mean2d=mean2d, conic=None, depth=z, radius=radius, valid=valid,
        opacity_comp=None,
    )


def quat_scale_to_cov3d(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T for (N,4) wxyz quats and (N,3) scales -> (N,3,3)."""
    from .lie import quat_to_rotmat

    R = quat_to_rotmat(quats)  # (N,3,3)
    RS = R * scales[:, None, :]  # R @ diag(s)
    return torch.einsum("nij,nkj->nik", RS, RS)


def project_gaussians(
    means: torch.Tensor,  # (N, 3) world
    quats: torch.Tensor,  # (N, 4) wxyz
    scales: torch.Tensor,  # (N, 3)
    viewmat: torch.Tensor,  # (4, 4) world->camera
    K: torch.Tensor,  # (3, 3)
    width: int,
    height: int,
    near_plane: float = 1e-2,
    far_plane: float = 1e10,
    eps2d: float = 0.3,
    radius_clip: float = 0.0,
    antialiased: bool = False,
) -> ProjectedGaussians:
    """Project 3D Gaussians into screen space (general, anisotropic).

    antialiased=False is the 'classic' mode the method uses; True adds the
    opacity compensation sqrt(det(cov)/det(cov+eps I))."""
    R_cw, x, y, z, zs, fx, fy, mean2d = _camera_terms(
        means, viewmat, K, width, height)

    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tx = zs * torch.minimum(torch.maximum(x / zs, -lim_x), lim_x)
    ty = zs * torch.minimum(torch.maximum(y / zs, -lim_y), lim_y)
    rz = 1.0 / zs
    rz2 = rz * rz
    cov3d = quat_scale_to_cov3d(quats, scales)  # (N,3,3)
    cov_cam = torch.einsum("ij,njk,lk->nil", R_cw, cov3d, R_cw)  # (N,3,3)

    j00 = fx * rz
    j02 = -fx * tx * rz2
    j11 = fy * rz
    j12 = -fy * ty * rz2
    c00 = cov_cam[:, 0, 0]
    c01 = cov_cam[:, 0, 1]
    c02 = cov_cam[:, 0, 2]
    c11 = cov_cam[:, 1, 1]
    c12 = cov_cam[:, 1, 2]
    c22 = cov_cam[:, 2, 2]
    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22)
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22)

    det_orig = a * c - b * b  # pre-dilation determinant (antialiased mode)
    a = a + eps2d
    c = c + eps2d

    det = a * c - b * b
    det_safe = torch.where(det == 0.0, 1e-12, det)
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    radius, valid = _radius_and_valid(
        a, c, det, z, mean2d, width, height, near_plane, far_plane,
        radius_clip)

    opacity_comp = None
    if antialiased:
        opacity_comp = torch.sqrt(
            det_orig.clamp_min(0.0) / det.clamp_min(1e-12)
        )

    return ProjectedGaussians(
        mean2d=mean2d, conic=conic, depth=z, radius=radius, valid=valid,
        opacity_comp=opacity_comp,
    )
