"""The TUM RGB-D layout: the frame cache, the clip folders the port's
`TUM` loader reads, and the reference's own reading of a clip (the
benchmark's association, frame-rate subsampling and first-pose
normalisation, after the TUM benchmark's tools)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

MAX_DT = 0.08  # association window, seconds


def _folder(root: Path, config: dict) -> Path:
    return root / f"rgbd_dataset_{config['scene']}"


def write_cache(dst: Path, config: dict) -> None:
    from gen import tum

    c = config
    tum.write(dst, c["scene"], frames=c["frames"], height=c["height"],
              width=c["width"], fx=c["fx"], fy=c["fy"], cx=c["cx"],
              cy=c["cy"], distortion=c["distortion"],
              scale=c["depth_scale"], crop_edge=c["crop_edge"],
              **c["generator"])


def _rows(path: Path) -> list:
    return [ln.split() for ln in path.read_text().splitlines()
            if ln.strip() and not ln.startswith("#")]


def sequence(folder: Path, frame_rate: float) -> list:
    """[(rgb row, depth row, groundtruth row)] of the associated frames
    kept at `frame_rate`: each rgb stamp takes the nearest depth and
    groundtruth stamps when both lie within MAX_DT, and a frame is kept
    when it comes more than 1/frame_rate after the last one kept."""
    rgb = _rows(folder / "rgb.txt")
    dep = _rows(folder / "depth.txt")
    gt = _rows(folder / "groundtruth.txt")
    t_dep = np.array([float(r[0]) for r in dep])
    t_gt = np.array([float(r[0]) for r in gt])
    assoc = []
    for r in rgb:
        t = float(r[0])
        j = int(np.argmin(np.abs(t_dep - t)))
        k = int(np.argmin(np.abs(t_gt - t)))
        if abs(t_dep[j] - t) < MAX_DT and abs(t_gt[k] - t) < MAX_DT:
            assoc.append((r, dep[j], gt[k]))
    kept = assoc[:1]
    for a in assoc[1:]:
        if float(a[0][0]) - float(kept[-1][0][0]) > 1.0 / frame_rate:
            kept.append(a)
    return kept


def make_clip(cache: Path, config: dict, frames: list, dst: Path) -> dict:
    """Link `frames` (indices into the kept sequence) into dst as a
    recording of their own; returns the runner's dataset arguments."""
    src, out = _folder(cache, config), _folder(dst, config)
    seq = sequence(src, config["frame_rate"])
    (out / "rgb").mkdir(parents=True)
    (out / "depth").mkdir()
    for name in ("cam_params.json", "groundtruth.txt"):
        (out / name).symlink_to(src / name)
    rgb_lines, dep_lines = [], []
    for f in frames:
        r, d, _ = seq[f]
        (out / r[1]).symlink_to(src / r[1])
        (out / d[1]).symlink_to(src / d[1])
        rgb_lines.append(" ".join(r))
        dep_lines.append(" ".join(d))
    (out / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (out / "depth.txt").write_text("\n".join(dep_lines) + "\n")
    return dict(data_set="TUM", scene_name=config["scene"], root=str(dst),
                frame_rate=config["frame_rate"])


def read_clip(dst: Path, config: dict) -> tuple:
    """(K float32 (3, 3) after the crop, [(depth float64 (H, W) in metres,
    cropped, c2w float32 (4, 4) relative to the clip's first frame)])."""
    import cv2
    from scipy.spatial.transform import Rotation

    folder = _folder(dst, config)
    cam = json.loads((folder / "cam_params.json").read_text())["camera"]
    ce = cam.get("crop_edge", 0)
    K = np.array([[cam["fx"], 0, cam["cx"] - ce],
                  [0, cam["fy"], cam["cy"] - ce], [0, 0, 1]], np.float32)
    out, inv_first = [], None
    for _r, d, g in sequence(folder, config["frame_rate"]):
        raw = cv2.imread(str(folder / d[1]), cv2.IMREAD_UNCHANGED)
        if raw is None or raw.dtype != np.uint16:
            raise ValueError(f"{folder / d[1]} is not a 16-bit PNG")
        depth = raw.astype(np.float32)
        if ce:
            depth = depth[ce:-ce, ce:-ce]
        v = np.array([float(x) for x in g[1:]])
        c2w = np.eye(4)
        c2w[:3, :3] = Rotation.from_quat(v[3:]).as_matrix()
        c2w[:3, 3] = v[:3]
        if inv_first is None:
            inv_first = np.linalg.inv(c2w)
            c2w = np.eye(4)
        else:
            c2w = inv_first @ c2w
        out.append((depth / cam["scale"], c2w.astype(np.float32)))
    return K, out
