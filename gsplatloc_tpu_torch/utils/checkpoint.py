"""Sequence-tracking checkpoint/resume.

Stores the per-pair pose estimates, error series and the next pair index
of a sequence run atomically (write to a temporary file, then rename), so
a killed run restarts mid-sequence. numpy only.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np


def save_checkpoint(
    run_dir: str | Path,
    next_pair: int,
    poses_est: list[np.ndarray],
    eT: list[float],
    eR: list[float],
    losses: list[float],
    steps: list[int],
    extra: dict | None = None,
):
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    tmp_npz = run_dir / ".ckpt.tmp.npz"
    np.savez_compressed(
        tmp_npz,
        poses_est=np.asarray(poses_est, np.float32).reshape(-1, 4, 4),
        eT=np.asarray(eT, np.float64),
        eR=np.asarray(eR, np.float64),
        losses=np.asarray(losses, np.float64),
        steps=np.asarray(steps, np.int64),
    )
    meta = {"next_pair": int(next_pair), **(extra or {})}
    tmp_json = run_dir / ".ckpt.tmp.json"
    tmp_json.write_text(json.dumps(meta))
    os.replace(tmp_npz, run_dir / "checkpoint.npz")
    os.replace(tmp_json, run_dir / "checkpoint.json")


def load_checkpoint(run_dir: str | Path):
    """Returns (next_pair, state dict) or (0, None) if no checkpoint."""
    run_dir = Path(run_dir)
    npz = run_dir / "checkpoint.npz"
    meta = run_dir / "checkpoint.json"
    if not (npz.exists() and meta.exists()):
        return 0, None
    data = np.load(npz)
    info = json.loads(meta.read_text())
    state = {
        "poses_est": list(data["poses_est"]),
        "eT": list(data["eT"]),
        "eR": list(data["eR"]),
        "losses": list(data["losses"]),
        "steps": list(data["steps"]),
        "wall_s": float(info.get("wall_s", 0.0)),
    }
    return int(info["next_pair"]), state
