"""TUM-format scene writer (frozen copy of
`gsplatloc_tpu_torch/data/tum_fixture.py:write_tum_fixture` without its
stress variant, taking the principal point and all five distortion
coefficients; at the fixture's centred principal point and DIST it writes
the fixture's files):

    <out>/rgbd_dataset_<scene>/{cam_params.json, rgb.txt, depth.txt,
        groundtruth.txt, rgb/<t>.png, depth/<t>.png}

the rgb stream at `rate` Hz with a 2 ms normal jitter drawn in frame
order, depth 15 ms later as uint16 clip(depth * 5000), groundtruth at 100
Hz slerped between the frame poses, colour resampled through the lens
distortion (OpenCV's model: k1, k2, p1, p2, k3).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from . import png
from .pool import render_frames
from .synthetic import box_room_trajectory

DIST = [0.04, -0.01, 0.0, 0.0, 0.0]  # k1, k2, p1, p2, k3
T0 = 1305031452.0  # TUM-style epoch seconds
TOL_PX = 1e-4  # largest residual of the inverted distortion, pixels
MAX_ITERS = 100


def distort_maps(K: np.ndarray, h: int, w: int, dist=DIST):
    """float32 (mapx, mapy): the pinhole pixel each distorted pixel shows.
    The distortion is inverted by fixed-point iteration, four rounds and
    then more until every pixel lies within TOL_PX of its target."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    k1, k2, p1, p2, k3 = dist
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    xd = (u - cx) / fx
    yd = (v - cy) / fy

    def model(x, y):
        """(radial factor, tangential x, tangential y) at (x, y)."""
        r2 = x * x + y * y
        f = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        return (f, 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x),
                p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)

    x, y = xd.copy(), yd.copy()
    for it in range(MAX_ITERS):
        f, tx, ty = model(x, y)
        x, y = (xd - tx) / f, (yd - ty) / f
        if it >= 3:
            f, tx, ty = model(x, y)
            err = np.hypot((x * f + tx - xd) * fx, (y * f + ty - yd) * fy)
            if err.max() <= TOL_PX:
                break
    else:
        raise ValueError(f"the distortion {dist} does not invert")
    return ((x * fx + cx).astype(np.float32),
            (y * fy + cy).astype(np.float32))


def remap_linear(img: np.ndarray, mapx: np.ndarray, mapy: np.ndarray):
    """Bilinear remap of a uint8 (H, W, C) image at float32 source
    coordinates, replicated border, in float32 (OpenCV's INTER_LINEAR)."""
    h, w = img.shape[:2]
    x0f, y0f = np.floor(mapx), np.floor(mapy)
    ax = (mapx - x0f)[..., None]
    ay = (mapy - y0f)[..., None]
    x0, y0 = x0f.astype(np.int64), y0f.astype(np.int64)

    def at(y, x):
        return img[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)].astype(
            np.float32)

    one = np.float32(1.0)
    top = at(y0, x0) * (one - ax) + at(y0, x0 + 1) * ax
    bot = at(y0 + 1, x0) * (one - ax) + at(y0 + 1, x0 + 1) * ax
    val = top * (one - ay) + bot * ay
    return np.clip(np.rint(val), 0, 255).astype(np.uint8)


def groundtruth_lines(poses, frames: int, rate: float) -> list:
    """100 Hz rows "t tx ty tz qx qy qz qw", translation interpolated
    linearly and rotation slerped between the rate-Hz poses."""
    from scipy.spatial.transform import Rotation

    lines = []
    for g in range(int(frames / rate * 100.0) + 10):
        tg = T0 - 0.02 + g * (1.0 / 100.0)
        fpos = np.clip((tg - T0) * rate, 0, frames - 1)
        i0 = int(np.floor(fpos))
        i1 = min(i0 + 1, frames - 1)
        a = fpos - i0
        trans = (1 - a) * poses[i0][:3, 3] + a * poses[i1][:3, 3]
        q0 = Rotation.from_matrix(poses[i0][:3, :3])
        q1 = Rotation.from_matrix(poses[i1][:3, :3])
        q = (q0 * ((q0.inv() * q1) ** a)).as_quat()  # xyzw slerp
        lines.append(f"{tg:.6f} " + " ".join(f"{v:.6f}" for v in trans)
                     + " " + " ".join(f"{v:.6f}" for v in q))
    return lines


def write(out: Path, scene: str, *, frames: int, height: int, width: int,
          fx: float, fy: float, scale: float, crop_edge: int, clutter: int,
          speed: float, seed: int, boxes: int = 0, rate: float = 30.0,
          cx: float | None = None, cy: float | None = None,
          distortion=DIST, workers: int | None = None) -> None:
    """The scene's files under `out`; cx, cy default to the image centre
    (the fixture's)."""
    H, W = height, width
    cx = W / 2 - 0.5 if cx is None else cx
    cy = H / 2 - 0.5 if cy is None else cy
    dist = [float(d) for d in distortion]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    root = out / f"rgbd_dataset_{scene}"
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(parents=True, exist_ok=True)
    (root / "cam_params.json").write_text(json.dumps({
        "camera": {"w": W, "h": H, "fx": fx, "fy": fy, "cx": cx, "cy": cy,
                   "scale": scale, "distortion": dist,
                   "crop_edge": crop_edge},
    }, indent=2))
    rng = np.random.default_rng(seed)
    poses = box_room_trajectory(frames, seed=seed, speed=speed)
    gt_lines = groundtruth_lines(poses, frames, rate)
    t_rgb = [T0 + i / rate + float(rng.normal(0, 0.002))
             for i in range(frames)]
    mapx, mapy = distort_maps(K, H, W, dist)
    jobs = [dict(c2w=poses[i], K=K, height=H, width=W, clutter=clutter,
                 boxes=boxes) for i in range(frames)]
    rgb_lines, dep_lines = [], []
    for i, (bgr, depth) in enumerate(render_frames(jobs, workers)):
        png.imwrite(root / "rgb" / f"{t_rgb[i]:.6f}.png",
                    remap_linear(bgr, mapx, mapy))
        rgb_lines.append(f"{t_rgb[i]:.6f} rgb/{t_rgb[i]:.6f}.png")
        t_dep = t_rgb[i] + 0.015
        d16 = np.clip(depth * scale, 0, 65535).astype(np.uint16)
        png.imwrite(root / "depth" / f"{t_dep:.6f}.png", d16)
        dep_lines.append(f"{t_dep:.6f} depth/{t_dep:.6f}.png")
    (root / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text("\n".join(dep_lines) + "\n")
    (root / "groundtruth.txt").write_text(
        "# timestamp tx ty tz qx qy qz qw\n" + "\n".join(gt_lines) + "\n")
