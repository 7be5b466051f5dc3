"""Novel-view camera paths (numpy, host side).

Look-at view matrices, the least-squares focus point of a trajectory,
elliptical fly-throughs around it, and uniform cubic B-spline paths
between keyframes. A copy of the JAX package's data/traj.py (numpy only),
kept bit for bit: the same poses give the same paths.
"""

from __future__ import annotations

import numpy as np


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def viewmatrix(lookdir: np.ndarray, up: np.ndarray,
               position: np.ndarray) -> np.ndarray:
    """Construct a c2w look-at matrix."""
    vec2 = normalize(lookdir)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    m = np.eye(4)
    m[:3, :3] = np.stack([vec0, vec1, vec2], axis=1)
    m[:3, 3] = position
    return m


def focus_point_fn(poses: np.ndarray) -> np.ndarray:
    """Least-squares point nearest to all camera z-axes."""
    directions = poses[:, :3, 2:3]
    origins = poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    focus = np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]
    return focus


def generate_ellipse_path_z(
    poses: np.ndarray,
    n_frames: int = 120,
    z_variation: float = 0.0,
    z_phase: float = 0.0,
) -> np.ndarray:
    """Elliptical path in the XY plane around the trajectory's focus point,
    cameras looking at it."""
    center = focus_point_fn(poses)
    offset = np.array([center[0], center[1], 0.0])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    low = -sc + offset
    high = sc + offset
    z_low = np.percentile(poses[:, 2, 3], 10)
    z_high = np.percentile(poses[:, 2, 3], 90)

    def get_positions(theta):
        return np.stack(
            [
                low[0] + (high[0] - low[0]) * (np.cos(theta) * 0.5 + 0.5),
                low[1] + (high[1] - low[1]) * (np.sin(theta) * 0.5 + 0.5),
                z_variation
                * (z_low + (z_high - z_low)
                   * (np.cos(theta + 2 * np.pi * z_phase) * 0.5 + 0.5))
                + (1 - z_variation) * center[2] * np.ones_like(theta),
            ],
            axis=-1,
        )

    theta = np.linspace(0, 2.0 * np.pi, n_frames + 1, endpoint=True)[:-1]
    positions = get_positions(theta)
    up = np.array([0.0, 0.0, 1.0])
    return np.stack(
        [viewmatrix(center - p, up, p) for p in positions]
    )


def generate_ellipse_path_y(
    poses: np.ndarray,
    n_frames: int = 120,
    variation: float = 0.0,
    phase: float = 0.0,
) -> np.ndarray:
    """Elliptical path in the XZ plane (y-up datasets)."""
    center = focus_point_fn(poses)
    offset = np.array([center[0], 0.0, center[2]])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    low = -sc + offset
    high = sc + offset
    y_low = np.percentile(poses[:, 1, 3], 10)
    y_high = np.percentile(poses[:, 1, 3], 90)

    def get_positions(theta):
        return np.stack(
            [
                low[0] + (high[0] - low[0]) * (np.cos(theta) * 0.5 + 0.5),
                variation
                * (y_low + (y_high - y_low)
                   * (np.cos(theta + 2 * np.pi * phase) * 0.5 + 0.5))
                + (1 - variation) * center[1] * np.ones_like(theta),
                low[2] + (high[2] - low[2]) * (np.sin(theta) * 0.5 + 0.5),
            ],
            axis=-1,
        )

    theta = np.linspace(0, 2.0 * np.pi, n_frames + 1, endpoint=True)[:-1]
    positions = get_positions(theta)
    up = np.array([0.0, 1.0, 0.0])
    return np.stack(
        [viewmatrix(center - p, up, p) for p in positions]
    )


def _bspline_basis(t: np.ndarray) -> np.ndarray:
    """Uniform cubic B-spline basis values for local parameter t in [0,1)."""
    t2, t3 = t * t, t * t * t
    b0 = (1 - t) ** 3 / 6.0
    b1 = (3 * t3 - 6 * t2 + 4) / 6.0
    b2 = (-3 * t3 + 3 * t2 + 3 * t + 1) / 6.0
    b3 = t3 / 6.0
    return np.stack([b0, b1, b2, b3], axis=-1)


def generate_interpolated_path(
    poses: np.ndarray,
    n_interp: int,
    look_at_neighbor: bool = True,
) -> np.ndarray:
    """Smooth uniform-cubic-B-spline path through keyframe camera positions
    with look-directions re-derived along the path (or the last
    keyframe's, look_at_neighbor=False). Returns
    (n_interp * (n_keyframes - 1), 4, 4)."""
    poses = np.asarray(poses)
    k = poses.shape[0]
    if k < 2:
        return poses.copy()
    pts = poses[:, :3, 3]
    # pad endpoints for the uniform cubic B-spline
    ctrl = np.concatenate([pts[:1], pts, pts[-1:]], axis=0)
    ups = poses[:, :3, 1]
    n_total = n_interp * (k - 1)
    out_pos = np.zeros((n_total, 3))
    out_up = np.zeros((n_total, 3))
    for i in range(n_total):
        u = i / n_interp  # global parameter in [0, k-1)
        seg = min(int(u), k - 2)
        t = u - seg
        basis = _bspline_basis(np.array(t))
        cp = ctrl[seg:seg + 4]
        out_pos[i] = basis @ cp
        w = t
        out_up[i] = normalize((1 - w) * ups[seg] + w * ups[min(seg + 1, k - 1)])
    mats = []
    for i in range(n_total):
        if look_at_neighbor and i + 1 < n_total:
            lookdir = out_pos[i + 1] - out_pos[i]
            if np.linalg.norm(lookdir) < 1e-8:
                lookdir = poses[min(int(i / n_interp), k - 1), :3, 2]
        else:
            lookdir = poses[-1, :3, 2]
        mats.append(viewmatrix(lookdir, out_up[i], out_pos[i]))
    return np.stack(mats)
