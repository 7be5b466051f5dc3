"""Rotation / SE(3) numerics (PyTorch, fp32).

Quaternions use (w, x, y, z) order throughout. All functions are batched
over leading dimensions and differentiable.
"""

from __future__ import annotations

import torch


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternion(s) to unit norm. q: (..., 4) wxyz."""
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (wxyz, any norm) -> rotation matrix (..., 3, 3)."""
    q = normalize_quat(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) wxyz.

    Branchless Shepperd-style selection of the numerically largest
    component."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def _safe_sqrt(x):
        return torch.sqrt(x.clamp_min(1e-24))

    sw = _safe_sqrt(1.0 + tr) * 2.0  # 4w
    qw0 = torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], -1)
    sx = _safe_sqrt(1.0 + m00 - m11 - m22) * 2.0  # 4x
    qx0 = torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx], -1)
    sy = _safe_sqrt(1.0 - m00 + m11 - m22) * 2.0  # 4y
    qy0 = torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy], -1)
    sz = _safe_sqrt(1.0 - m00 - m11 + m22) * 2.0  # 4z
    qz0 = torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz], -1)

    cond_w = (tr > 0.0)[..., None]
    cond_x = ((m00 > m11) & (m00 > m22))[..., None]
    cond_y = (m11 > m22)[..., None]
    q = torch.where(cond_w, qw0, torch.where(cond_x, qx0, torch.where(cond_y, qy0, qz0)))
    return normalize_quat(q)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D rotation rep (Zhou et al.) -> rotation matrix via Gram-Schmidt."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-12)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp_min(1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> 6D rep (first two rows)."""
    return m[..., :2, :].reshape(m.shape[:-2] + (6,))


def construct_pose(rotation: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """Build (..., 4, 4) SE(3) from (..., 3, 3) R and (..., 3) t."""
    batch = rotation.shape[:-2]
    top = torch.cat([rotation, translation[..., None]], dim=-1)  # (...,3,4)
    # the [0, 0, 0, 1] row made on the device: a tensor built from a host
    # list is a copy the host waits for
    bottom = rotation.new_zeros(batch + (1, 4))
    bottom[..., 3:].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def transform_points(matrix: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply SE(3) (4,4) to points (N,3) -> (N,3)."""
    return points @ matrix[:3, :3].T + matrix[:3, 3]


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a (..., 4, 4) rigid transform (R^T, -R^T t)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    new_t = -torch.sum(Rt * t[..., None, :], dim=-1)
    return construct_pose(Rt, new_t)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map se(3) -> SE(3) (4,4). xi = (wx, wy, wz, vx, vy, vz).
    Rodrigues with small-angle series."""
    w = xi[:3]
    v = xi[3:]
    th2 = torch.sum(w * w)
    th = torch.sqrt(th2 + 1e-24)
    small = th < 1e-6
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / (th2 + 1e-24))
    C = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (1.0 - A) / (th2 + 1e-24))
    zero = torch.zeros((), dtype=xi.dtype, device=xi.device)
    W = torch.stack([
        torch.stack([zero, -w[2], w[1]]),
        torch.stack([w[2], zero, -w[0]]),
        torch.stack([-w[1], w[0], zero]),
    ])
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + A * W + B * W2
    V = eye + B * W + C * W2
    return construct_pose(R, V @ v)
