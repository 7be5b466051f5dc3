"""Replica-format scene writer (frozen copy of the writer in
`scripts/make_replica_fixture.py`, whose frames `ReplicaFixture` yields):

    <out>/cam_params.json               the camera block, scale 6553.5
    <out>/<scene>/frame%06d.jpg         BGR colour, JPEG quality 95
    <out>/<scene>/depth%06d.png         uint16 clip(depth * scale)
    <out>/<scene>/traj.txt              row-major c2w, 9 decimals

Depth noise is not written: the benchmark's rooms have none.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .pool import render_frames
from .synthetic import box_room_trajectory


def write(out: Path, scene: str, *, frames: int, height: int, width: int,
          fx: float, fy: float, scale: float, clutter: int, speed: float,
          seed: int, boxes: int = 0, workers: int | None = None) -> None:
    import cv2

    cam = {"w": width, "h": height, "fx": fx, "fy": fy,
           "cx": width / 2 - 0.5, "cy": height / 2 - 0.5, "scale": scale}
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]],
                  [0, 0, 1]], np.float32)
    d = out / scene
    d.mkdir(parents=True, exist_ok=True)
    (out / "cam_params.json").write_text(
        json.dumps({"camera": cam}, indent=2))
    poses = box_room_trajectory(frames, seed=seed, speed=speed)
    jobs = [dict(c2w=c2w, K=K, height=height, width=width, clutter=clutter,
                 boxes=boxes) for c2w in poses]
    lines = []
    for i, (bgr, depth) in enumerate(render_frames(jobs, workers)):
        cv2.imwrite(str(d / f"frame{i:06d}.jpg"), bgr,
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        d16 = np.clip(depth * scale, 0, 65535).astype(np.uint16)
        cv2.imwrite(str(d / f"depth{i:06d}.png"), d16)
        lines.append(" ".join(f"{v:.9f}" for v in np.asarray(poses[i]).ravel()))
    (d / "traj.txt").write_text("\n".join(lines) + "\n")
