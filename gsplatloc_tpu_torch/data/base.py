"""Data-layer primitives: camera config loading, RGB-D frames, AlignData.

Parity with reference src/data/base.py (AlignData record :109-125),
src/data/Image.py (RGBDImage), src/data/utils.py (camera cfg loading).
Host-side arrays are numpy; device transfer happens at the Parser boundary.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np


def load_camera_cfg(path: str | Path) -> dict:
    """Load camera config from JSON or YAML (reference src/data/utils.py:12-25)."""
    path = Path(path)
    if path.suffix == ".json":
        with open(path) as f:
            cfg = json.load(f)
    elif path.suffix in (".yaml", ".yml"):
        import yaml

        with open(path) as f:
            cfg = yaml.safe_load(f)
    else:
        raise ValueError(f"unsupported camera config {path}")
    return cfg


def as_intrinsics_matrix(fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


@dataclass
class RGBDFrame:
    """One RGB-D frame: image data + intrinsics + GT camera-to-world pose.

    The camera-frame point cloud is computed lazily on device by the Parser
    (reference RGBDImage back-projects eagerly at construction, Image.py:29).
    """

    rgb: np.ndarray  # (H, W, 3) float, raw 0..255 range
    depth: np.ndarray  # (H, W) float, meters
    K: np.ndarray  # (3, 3)
    c2w: np.ndarray  # (4, 4)

    @property
    def hw(self) -> tuple[int, int]:
        return self.depth.shape[0], self.depth.shape[1]


@dataclass
class AlignData:
    """Per-frame-pair training record (device arrays; reference base.py:109-125)."""

    colors: object  # (N, 3) tar colors in [0,1]
    pixels: object  # (H, W, 3) src rgb in [0,1]
    tar_points: object  # (N, 3) world (pca-normalized)
    src_points: object  # (N, 3)
    src_depth: object  # (H, W) re-rendered GT depth
    tar_c2w: object  # (4, 4)
    src_c2w: object  # (4, 4)
    pca_factor: object  # scalar
    tar_nums: int = 0


@dataclass
class TrainData:
    """Single-frame variant of AlignData (reference base.py:128-141)."""

    points: object  # (N, 3) world
    colors: object  # (N, 3)
    pixels: object  # (H, W, 3)
    depth: object  # (H, W)
    c2w: object  # (4, 4)
    pca_factor: float = 1.0


def natsorted(paths):
    """Natural sort (numeric-aware), replacing the natsort dependency."""
    import re

    def key(p):
        s = str(p)
        return [int(tok) if tok.isdigit() else tok for tok in re.split(r"(\d+)", s)]

    return sorted(paths, key=key)
