"""Headless visualization: RGB-D comparison panels, trajectory plots,
depth colormaps.

`depth_to_colormap` needs no matplotlib: it looks viridis up in the table
of eval/viridis.py the way matplotlib's colormap does, pixel for pixel.
Every plot function draws a matplotlib-Agg figure and writes it to disk;
matplotlib is imported inside them only (the card's machine has none), and
a plot function raises an ImportError that names it when it is missing.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .viridis import VIRIDIS

_VIRIDIS = np.asarray(VIRIDIS, np.float64)  # (256, 3)


def _mpl():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "matplotlib is needed to draw this figure and is not installed "
            "(the depth colormap and `cli render` need none)") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def depth_to_colormap(depth: np.ndarray, cmap: str = "viridis"):
    """(H, W) depth -> (H, W, 3) uint8 viridis image: the valid (d > 0)
    depths normalized to [0, 1] over their range, looked up as matplotlib's
    colormap does (index int(norm * 256), norm == 1 at 255; a NaN gets the
    "bad" colour 0), invalid pixels 0, `(rgb * 255).astype(uint8)`."""
    if cmap != "viridis":
        raise ValueError(f"only the viridis colormap is held, not {cmap!r}")
    d = np.asarray(depth, np.float64)
    valid = d > 0
    lo = d[valid].min() if valid.any() else 0.0
    hi = d[valid].max() if valid.any() else 1.0
    x = np.clip((d - lo) / max(hi - lo, 1e-9), 0, 1) * len(_VIRIDIS)
    x[x == len(_VIRIDIS)] = len(_VIRIDIS) - 1
    bad = np.isnan(x) | ~valid
    rgb = _VIRIDIS[np.where(bad, 0.0, x).astype(int)]
    rgb[bad] = 0
    return (rgb * 255).astype(np.uint8)


def plot_rgbd_panel(
    depth_gt: np.ndarray,
    depth_rendered: np.ndarray,
    out_path: str | Path,
    rgb_gt: np.ndarray | None = None,
    rgb_rendered: np.ndarray | None = None,
    title: str = "",
):
    """GT vs rendered depth (+ optional RGB) comparison grid with diff and
    silhouette-edge diff (reference logger.plot_rgbd, 3x3 grid)."""
    import torch

    from ..ops.filters import sobel_magnitude

    plt = _mpl()
    d_gt = np.asarray(depth_gt)
    d_r = np.asarray(depth_rendered)
    e_gt = sobel_magnitude(torch.as_tensor(d_gt, dtype=torch.float32)).numpy()
    e_r = sobel_magnitude(torch.as_tensor(d_r, dtype=torch.float32)).numpy()
    sil = np.abs(e_gt - e_r)  # == eval.metrics.silhouette_diff
    rows = 3 if rgb_gt is not None else 2
    fig, axes = plt.subplots(rows, 3, figsize=(12, 3.2 * rows))
    axes = np.atleast_2d(axes)
    for ax in axes.ravel():
        ax.axis("off")
    axes[0, 0].imshow(d_gt, cmap="viridis")
    axes[0, 0].set_title("depth GT")
    axes[0, 1].imshow(d_r, cmap="viridis")
    axes[0, 1].set_title("depth rendered")
    im = axes[0, 2].imshow(np.abs(d_gt - d_r), cmap="magma")
    axes[0, 2].set_title("|depth diff|")
    fig.colorbar(im, ax=axes[0, 2], fraction=0.04)
    axes[1, 0].imshow(e_gt, cmap="gray")
    axes[1, 0].set_title("edges GT")
    axes[1, 1].imshow(e_r, cmap="gray")
    axes[1, 1].set_title("edges rendered")
    axes[1, 2].imshow(sil, cmap="magma")
    axes[1, 2].set_title("silhouette diff")
    if rgb_gt is not None:
        axes[2, 0].imshow(np.clip(np.asarray(rgb_gt), 0, 1))
        axes[2, 0].set_title("rgb GT")
        if rgb_rendered is not None:
            axes[2, 1].imshow(np.clip(np.asarray(rgb_rendered), 0, 1))
            axes[2, 1].set_title("rgb rendered")
            axes[2, 2].imshow(
                np.abs(np.asarray(rgb_gt) - np.asarray(rgb_rendered)).mean(-1),
                cmap="magma",
            )
            axes[2, 2].set_title("|rgb diff|")
    if title:
        fig.suptitle(title)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_trajectory(
    poses_est: np.ndarray,  # (F, 4, 4)
    out_path: str | Path,
    poses_gt: np.ndarray | None = None,
    axes_xy: tuple[int, int] = (0, 2),
):
    """2D top-down trajectory plot (reference PcdVisualizer._update_2d_plot)."""
    plt = _mpl()
    a, b = axes_xy
    fig, ax = plt.subplots(figsize=(6, 6))
    est = np.asarray(poses_est)
    ax.plot(est[:, a, 3], est[:, b, 3], "b-", label="estimated")
    if poses_gt is not None:
        gt = np.asarray(poses_gt)
        ax.plot(gt[:, a, 3], gt[:, b, 3], "g--", label="ground truth")
    ax.set_xlabel("xyz"[a])
    ax.set_ylabel("xyz"[b])
    ax.legend()
    ax.set_aspect("equal")
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_bar(labels, values, out_path: str | Path, title: str = "",
             ylabel: str = ""):
    """Bar chart of per-scene/per-method scalars (reference
    WandbLogger.plot_bar, src/eval/logger.py:244-256)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(max(4, 0.8 * len(labels)), 3.6))
    ax.bar(range(len(labels)), np.asarray(values, np.float64))
    ax.set_xticks(range(len(labels)))
    ax.set_xticklabels([str(l) for l in labels], rotation=45, ha="right")
    if ylabel:
        ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    ax.grid(alpha=0.3, axis="y")
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_error_series(series: dict, out_path: str | Path):
    """Per-frame eT/eR curves (reference visualize_trajectory + wandb
    scalar panels)."""
    plt = _mpl()
    fig, axes = plt.subplots(1, len(series), figsize=(5 * len(series), 3.2))
    if len(series) == 1:
        axes = [axes]
    for ax, (name, values) in zip(axes, series.items()):
        ax.plot(values)
        ax.set_title(name)
        ax.set_xlabel("frame")
        ax.grid(alpha=0.3)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return out_path


def _frustum_lines(c2w: np.ndarray, K: np.ndarray, wh=(1200, 680),
                   depth: float = 0.25):
    """Wireframe segments of a camera frustum (apex + 4 image-corner rays
    at `depth`) in world coordinates. Returns (8, 2, 3)."""
    w, h = wh
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    corners_px = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    rays = np.stack([(corners_px[:, 0] - cx) / fx,
                     (corners_px[:, 1] - cy) / fy,
                     np.ones(4)], axis=1) * depth
    R, t = np.asarray(c2w, np.float64)[:3, :3], np.asarray(c2w, np.float64)[:3, 3]
    pts = rays @ R.T + t  # (4, 3) world corners
    segs = [(t, p) for p in pts]
    segs += [(pts[i], pts[(i + 1) % 4]) for i in range(4)]
    return np.asarray(segs)


def visualize_point_cloud(
    points: np.ndarray,  # (N, 3)
    out_path: str | Path,
    colors: np.ndarray | None = None,  # (N, 3) in [0, 1]
    poses: np.ndarray | dict | None = None,  # (F, 4, 4) or {label: (4,4)}
    K: np.ndarray | None = None,
    wh: tuple[int, int] = (1200, 680),
    max_points: int = 60_000,
    views=((20, -60), (75, -90)),
    title: str = "",
    center_pose: np.ndarray | None = None,  # camera-following view center
):
    """Headless 3D point-cloud inspection: multi-view matplotlib scatter +
    camera frusta, written as ONE PNG (reference visualize_point_cloud +
    PcdVisualizer's camera-following window, src/component/visualize.py:
    13-69, 91-209 — GUI replaced by offscreen turntable views)."""
    plt = _mpl()
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    if colors is not None:
        colors = np.clip(np.asarray(colors, np.float64).reshape(-1, 3), 0, 1)
    if pts.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(pts.shape[0], max_points,
                                              replace=False)
        pts = pts[sel]
        colors = colors[sel] if colors is not None else None

    pose_items = []
    if poses is not None:
        if isinstance(poses, dict):
            pose_items = list(poses.items())
        else:
            arr = np.asarray(poses)
            pose_items = [(f"{i}", arr[i]) for i in range(arr.shape[0])]

    fig = plt.figure(figsize=(6 * len(views), 6))
    span = np.percentile(pts, 95, axis=0) - np.percentile(pts, 5, axis=0)
    fr_depth = 0.12 * float(np.max(span)) if pts.size else 0.25
    frustum_colors = ["tab:red", "tab:green", "tab:orange", "tab:purple"]
    for vi, (elev, azim) in enumerate(views):
        ax = fig.add_subplot(1, len(views), vi + 1, projection="3d")
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.3,
                   c=colors if colors is not None else pts[:, 2],
                   cmap=None if colors is not None else "viridis",
                   linewidths=0, rasterized=True)
        if pose_items and K is not None:
            traj = np.stack([p[:3, 3] for _, p in pose_items])
            ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], "r-", lw=1.0)
            # frusta for up to 6 poses (first/last always included)
            show = pose_items if len(pose_items) <= 6 else (
                pose_items[:: max(1, len(pose_items) // 5)] + [pose_items[-1]])
            for fi, (label, p) in enumerate(show):
                col = frustum_colors[fi % len(frustum_colors)]
                for a, b in _frustum_lines(p, np.asarray(K), wh, fr_depth):
                    ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]],
                            color=col, lw=0.8)
                ax.text(*p[:3, 3], label, fontsize=7, color=col)
        # camera-following view (PcdVisualizer._follow_camera parity):
        # center the axes box on the (latest) camera position
        if center_pose is not None:
            c = np.asarray(center_pose, np.float64)[:3, 3]
            r = 0.75 * float(np.max(span)) if pts.size else 1.0
            ax.set_xlim(c[0] - r, c[0] + r)
            ax.set_ylim(c[1] - r, c[1] + r)
            ax.set_zlim(c[2] - r, c[2] + r)
        ax.view_init(elev=elev, azim=azim)
        ax.set_box_aspect((1, 1, 1))
    if title:
        fig.suptitle(title)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out_path


class PcdInspector:
    """Accumulating headless counterpart of the reference's PcdVisualizer
    (src/component/visualize.py:13-69): each update adds a (downsampled)
    cloud transformed by its estimated pose plus the pose itself; save()
    renders the accumulated map + trajectory + frusta, view centered on
    the latest camera (the reference's camera-following view control)."""

    def __init__(self, K: np.ndarray, wh=(1200, 680),
                 points_per_update: int = 15_000):
        self.K = np.asarray(K)
        self.wh = wh
        self.ppu = points_per_update
        self._pts: list = []
        self._cols: list = []
        self._poses: list = []

    def update(self, points: np.ndarray, est_pose: np.ndarray,
               colors: np.ndarray | None = None):
        pts = np.asarray(points, np.float64).reshape(-1, 3)
        if pts.shape[0] > self.ppu:
            sel = np.random.default_rng(len(self._poses)).choice(
                pts.shape[0], self.ppu, replace=False)
            pts = pts[sel]
            colors = (np.asarray(colors).reshape(-1, 3)[sel]
                      if colors is not None else None)
        T = np.asarray(est_pose, np.float64)
        self._pts.append(pts @ T[:3, :3].T + T[:3, 3])
        self._cols.append(
            np.clip(np.asarray(colors, np.float64), 0, 1)
            if colors is not None else np.full_like(pts, 0.55))
        self._poses.append(T)

    def save(self, out_path: str | Path, title: str = ""):
        if not self._poses:
            return None
        return visualize_point_cloud(
            np.concatenate(self._pts), out_path,
            colors=np.concatenate(self._cols),
            poses=np.stack(self._poses), K=self.K, wh=self.wh,
            title=title, center_pose=self._poses[-1],
        )
