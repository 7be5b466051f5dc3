"""The Replica layout: the frame cache, the clip folders the port's
`Replica` loader reads, and the reference's own reading of a clip."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def write_cache(dst: Path, config: dict) -> None:
    from gen import replica

    c = config
    replica.write(dst, c["scene"], frames=c["frames"], height=c["height"],
                  width=c["width"], fx=c["fx"], fy=c["fy"],
                  scale=c["depth_scale"], **c["generator"])


def make_clip(cache: Path, config: dict, frames: list, dst: Path) -> dict:
    """Link `frames` of the cached scene into dst as a scene of their own
    (numbered from 0, their traj.txt rows in order); returns the runner's
    dataset arguments."""
    scene = config["scene"]
    src, out = cache / scene, dst / scene
    out.mkdir(parents=True)
    (dst / "cam_params.json").symlink_to(cache / "cam_params.json")
    traj = (src / "traj.txt").read_text().splitlines()
    for j, f in enumerate(frames):
        (out / f"frame{j:06d}.jpg").symlink_to(src / f"frame{f:06d}.jpg")
        (out / f"depth{j:06d}.png").symlink_to(src / f"depth{f:06d}.png")
    (out / "traj.txt").write_text("\n".join(traj[f] for f in frames) + "\n")
    return dict(data_set="Replica", scene_name=scene, root=str(dst))


def read_clip(dst: Path, config: dict) -> tuple:
    """(K float32 (3, 3), [(depth float64 (H, W) in metres, c2w float32
    (4, 4)), ...]) of a clip folder, read with OpenCV and numpy."""
    import cv2

    cam = json.loads((dst / "cam_params.json").read_text())["camera"]
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]],
                  [0, 0, 1]], np.float32)
    d = dst / config["scene"]
    rows = (d / "traj.txt").read_text().splitlines()
    out = []
    for j, row in enumerate(rows):
        raw = cv2.imread(str(d / f"depth{j:06d}.png"), cv2.IMREAD_UNCHANGED)
        if raw is None or raw.dtype != np.uint16:
            raise ValueError(f"{d}/depth{j:06d}.png is not a 16-bit PNG")
        c2w = np.array([float(v) for v in row.split()]).reshape(4, 4)
        out.append((raw.astype(np.float64) / cam["scale"],
                    c2w.astype(np.float32)))
    return K, out
