"""What decides `correct`: the poses the window produced, against the
plain reference (plainref/) tracking the same pairs from the same files.

For each pair the seed samples, the reference reads the clip's depth
frames and poses with its own loader (layouts/<dataset>.py:read_clip),
redoes the whole prepare (back-projection, PCA normalisation, exact kNN
scales over scipy's tree, the scene: plainref/pair.py) and the
configuration's tracking path, its depth target and its loop
(plainref/paths/<path>.py, the path named by harness.tracking_path), in
plain PyTorch float32 with TF32 off, and the two best poses are compared
in the pair's normalized frame:

    pose_gap_cm     distance between the two best translations (x 100,
                    the unit the runner reports eT in)
    rot_gap_deg     angle between the two best rotations
    missing_pairs   pairs of the window with no pose

Each is held to the cell's limit (cells/<cell>.json "limits").
"""

from __future__ import annotations

import contextlib

import numpy as np


def rotation_gap_deg(a: np.ndarray, b: np.ndarray) -> float:
    """Angle between the rotations of two poses, from the chord
    |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2), which keeps its resolution
    near zero (arccos of the trace does not)."""
    chord = np.linalg.norm(a[:3, :3] - b[:3, :3])
    return float(np.degrees(2.0 * np.arcsin(min(1.0, chord / 8 ** 0.5))))


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 off (the reference) or on (its control) for matmuls and
    convolutions while the reference runs."""
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def reference_pairs(window, checked: list, device: str,
                    tf32: bool = False) -> dict:
    """{(clip, pair): the reference's track_pair output} of the checked
    pairs, each read from its clip's folder; tf32=True makes it the
    control (calibrate.py)."""
    from harness import adapter, reference
    from plainref.opt.tracking import TrackingConfig

    cfg = window.cfg
    mod = adapter(cfg)
    track_pair = reference(window.path).track_pair
    tracking = TrackingConfig(**cfg["tracking"])
    out, clips = {}, {}
    with matmul_precision(tf32):
        for c, j in checked:
            if c not in clips:
                clips[c] = mod.read_clip(window.clips[c][1], cfg)
            K, frames = clips[c]
            (td, tc), (sd, sc) = frames[j], frames[j + 1]
            out[(c, j)] = track_pair(td, tc, sd, sc, K, tracking, device)
    return out


def readings(runs: list, refs: dict) -> dict:
    """The numbers compared: the worst gap over the checked pairs (each
    against the first run of its clip) and the pairs with no pose."""
    poses, missing = {}, 0
    for r in runs:
        est = r.result.poses_est
        missing += max(0, len(r.frames) - 1 - len(est))
        for j, p in enumerate(est):
            poses.setdefault((r.clip, j), np.asarray(p, np.float64))
    t_gap, r_gap = 0.0, 0.0
    for key, ref in refs.items():
        if key not in poses:
            missing += 1
            continue
        p, q = poses[key], ref["best_c2w"]
        t_gap = max(t_gap, float(np.linalg.norm(p[:3, 3] - q[:3, 3])) * 100)
        r_gap = max(r_gap, rotation_gap_deg(p, q))
    return {"pose_gap_cm": t_gap, "rot_gap_deg": r_gap,
            "missing_pairs": float(missing)}


def judge(values: dict, limits: dict) -> dict:
    """({name: {"value", "limit"}} in the limits' order, whether every
    value is within its limit; a NaN is not)."""
    out = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in out.values())
    return out, ok
