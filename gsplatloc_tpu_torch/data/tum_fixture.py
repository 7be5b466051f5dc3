"""Write a TUM-format fixture sequence, without OpenCV.

The port's counterpart of `scripts/make_tum_fixture.py`, with its arguments
and defaults:

    python -m gsplatloc_tpu_torch.data.tum_fixture [--frames 40] \
        [--stress] [--scene freiburg1_desk] [--out datasets/TUM_fixture]

writes OUT/rgbd_dataset_<scene>/{cam_params.json, rgb.txt, depth.txt,
groundtruth.txt, rgb/*.png, depth/*.png} as the script does:

  * the rgb stream at `--rate` Hz (30; 10 with --stress) with a normal
    jitter of 2 ms per frame, drawn from `default_rng(seed)` in frame
    order, the depth stream 15 ms later, groundtruth at 100 Hz, slerped
    between the frame poses;
  * with --stress, from `default_rng(seed + 77)`: ~12 % of the depth
    frames dropped, ~8 % written 120 ms late, and no groundtruth row within
    0.09 s of frames frames//2 .. frames//2 + 2;
  * the text files and `cam_params.json` formatted as the script formats
    them, so they equal its files byte for byte;
  * depth as `clip(depth * 5000, 0, 65535).astype(uint16)` in a 16-bit PNG;
  * colour resampled through the radial distortion model DIST (the
    script's `_distort_rgb`) by `undistort.remap_linear`, which equals
    `cv2.remap(..., INTER_LINEAR, BORDER_REPLICATE)` with float32 maps.

Frames render in the worker processes of `data/fixtures.py` (numpy and
scipy only, started as new programs, never forked from a process that may
hold CUDA). `SUITE` names the arguments of the two scenes the reference's
fixture suite tracked.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from . import png
from .fixtures import RenderPool, default_workers
from .synthetic import box_room_trajectory
from .undistort import remap_linear

DIST = [0.04, -0.01, 0.0, 0.0, 0.0]  # k1, k2, p1, p2, k3
T0 = 1305031452.0  # TUM-style epoch seconds
DEPTH_SCALE = 5000.0  # TUM depth convention

# scene -> the writer's arguments, for the two scenes of the reference's
# suite (runs/tpu_session_r5b/suite/tum_desk, tum_stress). desk is
# `--frames 40` at the defaults, the reference's 33 pairs with its clamp
# counts. stress's arguments are not recorded; no (frames, seed) whose
# clocks give its 27 pairs also gives its clamp counts, so it is written
# at the defaults (30 pairs) and compared with the reference's run only
# in its accuracy class
SUITE = {
    "freiburg1_desk": dict(frames=40),
    "freiburg2_stress": dict(frames=40, stress=True),
}
# the scenes whose per-pair records the writer reproduces
PER_PAIR = ("freiburg1_desk",)


def distort_maps(K: np.ndarray, h: int, w: int, dist=DIST):
    """float32 (mapx, mapy): the pinhole pixel each distorted pixel shows
    (the normalized inversion is a 4-round fixed point)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    k1, k2 = dist[0], dist[1]
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    xd = (u - cx) / fx
    yd = (v - cy) / fy
    x, y = xd.copy(), yd.copy()
    for _ in range(4):
        r2 = x * x + y * y
        f = 1.0 + k1 * r2 + k2 * r2 * r2
        x, y = xd / f, yd / f
    return ((x * fx + cx).astype(np.float32),
            (y * fy + cy).astype(np.float32))


def stress_events(frames: int, seed: int, rate: float):
    """(dropped depth frames, late depth frames, groundtruth outage window
    (t_lo, t_hi)) of the stress variant."""
    srng = np.random.default_rng(seed + 77)
    drop, late = set(), set()
    for i in range(1, frames):  # frame 0 stays intact (identity)
        r = srng.random()
        if r < 0.12:
            drop.add(i)
        elif r < 0.20:
            late.add(i)
    g0 = frames // 2
    return drop, late, (T0 + g0 / rate - 0.09, T0 + (g0 + 2) / rate + 0.09)


def groundtruth_lines(poses, frames: int, rate: float, gap=None) -> list:
    """The 100 Hz groundtruth rows "t tx ty tz qx qy qz qw": translation
    interpolated linearly, rotation slerped between the rate-Hz poses,
    rows inside the outage window `gap` left out."""
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
        if gap is not None and gap[0] <= tg <= gap[1]:
            continue
        lines.append(f"{tg:.6f} " + " ".join(f"{v:.6f}" for v in trans)
                     + " " + " ".join(f"{v:.6f}" for v in q))
    return lines


def write_tum_fixture(out="datasets/TUM_fixture", *, frames: int = 40,
                      height: int = 480, width: int = 640, clutter: int = 40,
                      seed: int = 5, speed: float = 1.5,
                      scene: str = "freiburg1_desk", boxes: int = 0,
                      rate: float | None = None, stress: bool = False,
                      workers: int | None = None, quiet: bool = True) -> Path:
    """Write one TUM-format scene under `out`; returns its folder."""
    H, W = height, width
    fx = fy = 520.0 * (W / 640.0)
    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)

    root = Path(out) / f"rgbd_dataset_{scene}"
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(parents=True, exist_ok=True)
    (root / "cam_params.json").write_text(json.dumps({
        "camera": {"w": W, "h": H, "fx": fx, "fy": fy, "cx": cx, "cy": cy,
                   "scale": DEPTH_SCALE, "distortion": DIST, "crop_edge": 8},
    }, indent=2))

    rng = np.random.default_rng(seed)
    poses = box_room_trajectory(frames, seed=seed, speed=speed)
    rate = rate if rate is not None else (10.0 if stress else 30.0)
    drop, late, gap = (stress_events(frames, seed, rate) if stress
                       else (set(), set(), None))
    gt_lines = groundtruth_lines(poses, frames, rate, gap)
    # the clocks draw from rng in frame order; the renders draw nothing
    t_rgb = [T0 + i / rate + float(rng.normal(0, 0.002))
             for i in range(frames)]
    mapx, mapy = distort_maps(K, H, W)

    pool = RenderPool(workers or default_workers())
    try:
        futures = [pool.submit(c2w=poses[i], K=K, height=H, width=W,
                               clutter=clutter, boxes=boxes)
                   for i in range(frames)]
        rgb_lines, dep_lines = [], []
        for i, fut in enumerate(futures):
            bgr, depth = fut.result()
            png.imwrite(root / "rgb" / f"{t_rgb[i]:.6f}.png",
                        remap_linear(bgr, mapx, mapy))
            rgb_lines.append(f"{t_rgb[i]:.6f} rgb/{t_rgb[i]:.6f}.png")
            if i not in drop:
                t_dep = t_rgb[i] + (0.12 if i in late else 0.015)
                d16 = np.clip(depth * DEPTH_SCALE, 0, 65535).astype(np.uint16)
                png.imwrite(root / "depth" / f"{t_dep:.6f}.png", d16)
                dep_lines.append(f"{t_dep:.6f} depth/{t_dep:.6f}.png")
            if not quiet and (i + 1) % 20 == 0:
                print(f"{i + 1}/{frames} frames", flush=True)
    finally:
        pool.close()

    (root / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text("\n".join(dep_lines) + "\n")
    (root / "groundtruth.txt").write_text(
        "# timestamp tx ty tz qx qy qz qw\n" + "\n".join(gt_lines) + "\n")
    if not quiet:
        if stress:
            print(f"stress: dropped depth {sorted(drop)}, late depth "
                  f"{sorted(late)}, gt outage frames ~{frames // 2}-"
                  f"{frames // 2 + 2}")
        print(f"wrote {frames} frames ({W}x{H}) to {root}")
    return root


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--clutter", type=int, default=40)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--speed", type=float, default=1.5)
    ap.add_argument("--scene", default="freiburg1_desk")
    ap.add_argument("--out", default="datasets/TUM_fixture")
    ap.add_argument("--boxes", type=int, default=0,
                    help="furniture-like cuboid clutter (clutter_boxes)")
    ap.add_argument("--rate", type=float, default=None,
                    help="capture rate in Hz (default 30; 10 with --stress)")
    ap.add_argument("--stress", action="store_true",
                    help="association-stress variant: dropped and late "
                         "depth frames and a groundtruth outage")
    args = ap.parse_args(argv)
    write_tum_fixture(args.out, frames=args.frames, height=args.height,
                      width=args.width, clutter=args.clutter, seed=args.seed,
                      speed=args.speed, scene=args.scene, boxes=args.boxes,
                      rate=args.rate, stress=args.stress, quiet=False)


if __name__ == "__main__":
    main()
