"""Synthetic RGB-D scenes + trajectories: the benchmark's frozen copy of
the box-room generator (`gsplatloc_tpu_torch/data/synthetic.py`), which
renders the Replica-format and TUM-format scenes its cells read.

Original summary:

Provides the CPU-runnable configs from BASELINE.json ("Synthetic 1k random
Gaussians -> 256x256 RGB-D render + pose-grad check") and a procedural box
room that exercises the full tracking pipeline (depth back-projection, PCA
normalization, depth-GT re-rendering, pose optimization) end-to-end without
Replica/TUM on disk.
"""

from __future__ import annotations

import numpy as np


def random_gaussian_cloud(rng: np.random.Generator, n: int, extent: float = 1.0):
    """Random points/colors in a box in front of the camera (z in [2, 4])."""
    pts = np.stack(
        [
            rng.uniform(-extent, extent, n),
            rng.uniform(-extent, extent, n),
            rng.uniform(2.0, 4.0, n),
        ],
        axis=1,
    ).astype(np.float32)
    rgb = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    return pts, rgb


def _box_ray_depth(origins, dirs, half: float):
    """Ray/axis-aligned-box (interior) intersection depth along each ray.

    origins: (3,), dirs: (..., 3) world-frame unit-ish rays from inside the
    [-half, half]^3 box. Returns t>0 distance to the first wall hit.
    """
    eps = 1e-9
    d = np.where(np.abs(dirs) < eps, eps, dirs)
    # candidate t for each axis: to +half if dir>0 else -half
    target = np.where(d > 0, half, -half)
    t_axis = (target - origins) / d  # (..., 3)
    t_axis = np.where(t_axis <= 0, np.inf, t_axis)
    return np.min(t_axis, axis=-1)


def _checker_color(points, scale: float = 0.5):
    """Procedural 3D checkerboard RGB in [0,1] for texture."""
    q = np.floor(points / scale).astype(np.int64)
    c = (q[..., 0] + q[..., 1] + q[..., 2]) % 2
    base = np.stack(
        [
            0.3 + 0.6 * c,
            0.5 + 0.3 * np.cos(points[..., 0]),
            0.4 + 0.4 * (1 - c),
        ],
        axis=-1,
    )
    return np.clip(base, 0.0, 1.0).astype(np.float32)


# Interior objects (center xyz, radius): depth discontinuities in every
# direction, so all 6 pose DoF are observable from the depth loss (a bare box
# room leaves lateral translation nearly unconstrained — flat walls don't
# change depth when sliding sideways).
_SPHERES = np.array(
    [
        [0.6, 0.2, 1.2, 0.45],
        [-0.8, -0.4, 0.8, 0.35],
        [0.1, 0.7, 2.0, 0.5],
        [-0.4, 0.8, 0.2, 0.3],
        [0.9, -0.7, 2.2, 0.4],
        [-1.2, 0.1, 1.6, 0.25],
    ]
)


def _sphere_ray_depth(origins, dirs, spheres):
    """Min positive ray-sphere intersection t (inf if none)."""
    t_min = np.full(dirs.shape[:-1], np.inf)
    d2 = np.sum(dirs * dirs, axis=-1)
    for cx_, cy_, cz_, r in spheres:
        oc = origins - np.array([cx_, cy_, cz_])
        b = np.sum(dirs * oc, axis=-1)
        c = np.dot(oc, oc) - r * r
        disc = b * b - d2 * c
        ok = disc > 0
        sq = np.sqrt(np.maximum(disc, 0.0))
        t0 = (-b - sq) / d2
        t0 = np.where(ok & (t0 > 1e-4), t0, np.inf)
        t_min = np.minimum(t_min, t0)
    return t_min


def clutter_spheres(n: int, seed: int = 11, half: float = 3.0) -> np.ndarray:
    """Extra deterministic interior spheres (center xyz, radius).

    The base room's 6 spheres leave the depth-only pose loss weakly
    conditioned: the rendered-vs-rendered resampling noise floor is flat
    within ~2-4 deg of rotation (measured at 680x1200 — loss at a 2.6 deg-off
    pose is within 12% of the GT-pose floor). Dense clutter adds depth
    edges/curvature at many orientations, sharpening the basin the way real
    cluttered rooms (the reference's Replica scenes) do."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.75 * half, 0.75 * half, (4 * n, 3))
    radii = rng.uniform(0.05 * half, 0.15 * half, (4 * n, 1))
    # keep clear of the camera trajectory region around (0, 0, -1)
    clear = np.linalg.norm(
        centers - np.array([0.0, 0.0, -1.0]), axis=1
    ) > radii[:, 0] + 0.2 * half
    return np.concatenate([centers, radii], axis=1)[clear][:n]


def clutter_boxes(n: int, seed: int = 23, half: float = 3.0) -> np.ndarray:
    """Deterministic interior axis-aligned cuboids (cx, cy, cz, hx, hy, hz)
    — desk/shelf/cabinet-like furniture for OFFICE-style fixture scenes
    (reference office0-4). Boxes give planar faces + straight depth edges
    at right angles, a different conditioning class from the spheres'
    curved silhouettes (VERDICT r3 next #6: office-like layouts)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.72 * half, 0.72 * half, (6 * n, 3))
    halfs = rng.uniform(0.04 * half, 0.22 * half, (6 * n, 3))
    # keep clear of the camera trajectory region around (0, 0, -1)
    clear = np.linalg.norm(
        centers - np.array([0.0, 0.0, -1.0]), axis=1
    ) > np.linalg.norm(halfs, axis=1) + 0.25 * half
    return np.concatenate([centers, halfs], axis=1)[clear][:n]


def _aabb_exterior_ray_depth(origins, dirs, boxes):
    """Min positive entry t of each ray into any exterior AABB (slab
    method; inf if none)."""
    eps = 1e-9
    d = np.where(np.abs(dirs) < eps, eps, dirs)
    t_min = np.full(dirs.shape[:-1], np.inf)
    for cx_, cy_, cz_, hx, hy, hz in boxes:
        lo = np.array([cx_ - hx, cy_ - hy, cz_ - hz])
        hi = np.array([cx_ + hx, cy_ + hy, cz_ + hz])
        t1 = (lo - origins) / d
        t2 = (hi - origins) / d
        tn = np.max(np.minimum(t1, t2), axis=-1)
        tf = np.min(np.maximum(t1, t2), axis=-1)
        hit = (tn <= tf) & (tn > 1e-4)
        t_min = np.minimum(t_min, np.where(hit, tn, np.inf))
    return t_min


def box_room_frame(c2w: np.ndarray, K: np.ndarray, height: int, width: int,
                   half: float = 3.0, clutter: int = 0, boxes: int = 0):
    """Render one analytic RGB-D frame of the box-room (+ interior spheres)
    from pose c2w.

    Depth convention matches the datasets': depth = z in camera frame (not
    ray length). Returns (rgb (H,W,3) float in [0,1], depth (H,W) float).
    clutter > 0 adds that many extra deterministic spheres (clutter_spheres);
    boxes > 0 adds that many furniture-like cuboids (clutter_boxes).
    """
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = np.arange(width, dtype=np.float64)[None, :]
    v = np.arange(height, dtype=np.float64)[:, None]
    ray_cam = np.stack(
        [
            np.broadcast_to((u - cx) / fx, (height, width)),
            np.broadcast_to((v - cy) / fy, (height, width)),
            np.ones((height, width)),
        ],
        axis=-1,
    )  # (H, W, 3), z=1
    R = c2w[:3, :3]
    t = c2w[:3, 3]
    ray_world = ray_cam @ R.T
    t_box = _box_ray_depth(t, ray_world, half)
    spheres = _SPHERES
    if clutter:
        spheres = np.concatenate([spheres, clutter_spheres(clutter, half=half)])
    t_sph = _sphere_ray_depth(t, ray_world, spheres)
    t_hit = np.minimum(t_box, t_sph)
    if boxes:
        t_cub = _aabb_exterior_ray_depth(t, ray_world, clutter_boxes(boxes, half=half))
        t_hit = np.minimum(t_hit, t_cub)
    # ray_cam has z=1, so t_hit IS the camera-frame z depth.
    depth = t_hit.astype(np.float32)
    hit_pts = t + ray_world * t_hit[..., None]
    rgb = _checker_color(hit_pts)
    return rgb, depth


def box_room_trajectory(n_frames: int, seed: int = 0, speed: float = 1.0):
    """Smooth camera motion inside the box room; returns (F,4,4) c2w.
    speed scales the translational/rotational velocity (1.0 ~ Replica-like
    frame-to-frame motion at these scales)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    poses = []
    pos = np.array([0.0, 0.0, -1.0])
    rotvec = np.zeros(3)
    vel = rng.normal(0, 0.004 * speed, 3)
    rvel = rng.normal(0, 0.002 * speed, 3)
    for _ in range(n_frames):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_rotvec(rotvec).as_matrix()
        T[:3, 3] = pos
        poses.append(T.astype(np.float32))
        vel += rng.normal(0, 0.001 * speed, 3)
        rvel += rng.normal(0, 0.0005 * speed, 3)
        pos = pos + vel
        rotvec = rotvec + rvel
    return np.stack(poses)
