"""Classical scan-to-scan ICP tracking and the baseline sweep.

The counterpart of `gsplatloc_tpu/tracking/icp.py` (reference
Scan2ScanICP, src/component/tracker.py:9-252, and the ICPExperiment /
icps_eval sweep, src/eval/experiment.py:62-149, src/icps_eval.py:26-85):
frame-to-frame registration of depth-derived point clouds with ICP /
PLANE_ICP / GICP / COLORED_ICP (the host C++ library, `native`), or the
dense hybrid RGB-D odometry (HYBRID, `tracking/odometry.py`, on the run's
device), accumulating T_world_camera, per-frame eT/eR against the ground
truth, and a resume ledger for sweeps.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from .. import native
from .._device import as_f32, resolve_device
from ..eval.logger import ExperimentLogger
from ..eval.metrics import rmse, rotation_error_deg, translation_error
from ..ops.camera import depth_to_points


def _voxel_average(pc: np.ndarray, res: float) -> np.ndarray:
    """Voxel-grid downsample of an (N, C) array (xyz + extra channels) by
    per-voxel centroid averaging over ALL columns (Open3D
    voxel_down_sample semantics, used for the colored path)."""
    keys = np.floor(pc[:, :3] / res).astype(np.int64)
    _, inv, counts = np.unique(
        keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.shape[0], pc.shape[1]), np.float64)
    np.add.at(sums, inv.ravel(), pc)
    return sums / counts[:, None]


@dataclass
class Scan2ScanICP:
    """Frame-to-frame registration tracker (reference tracker.py:9-136)."""

    max_corresponding_distance: float = 0.1
    voxel_downsampling_resolution: float = 0.0
    knn: int = 20
    num_threads: int = 4
    # ICP | PLANE_ICP | GICP | COLORED_ICP | HYBRID (dense RGB-D odometry)
    registration_type: str = "GICP"
    max_iterations: int = 20
    device: str = "cuda"  # where HYBRID's odometry runs

    previous_pcd: np.ndarray | None = None
    previous_tree: object | None = None
    previous_normals: np.ndarray | None = None
    previous_covs: np.ndarray | None = None
    previous_colors: np.ndarray | None = None
    last_rgbd: tuple | None = None  # (rgb, depth) for HYBRID
    T_world_camera: np.ndarray = field(default_factory=lambda: np.eye(4))

    def align(
        self,
        raw_points: np.ndarray,
        init_gt_pose: np.ndarray | None = None,
        T_last_current: np.ndarray | None = None,
    ) -> np.ndarray:
        """Register this scan against the previous one; returns the
        accumulated T_world_camera (reference tracker.py:85-136).

        raw_points: (N, 3) xyz, or (N, 4+) with intensity in column 3 for
        COLORED_ICP.
        """
        pts = np.ascontiguousarray(raw_points[:, :3], np.float64)
        colors = (np.ascontiguousarray(raw_points[:, 3], np.float64)
                  if raw_points.shape[1] > 3 else None)
        if self.voxel_downsampling_resolution > 0.0:
            if colors is None:
                pts = native.voxel_downsample(
                    pts, self.voxel_downsampling_resolution)
            else:
                # carry the voxel-AVERAGED intensity through the downsample
                # (Open3D's voxel_down_sample averages colours)
                pc = _voxel_average(
                    np.concatenate([pts, colors[:, None]], axis=1),
                    self.voxel_downsampling_resolution)
                pts = np.ascontiguousarray(pc[:, :3])
                colors = np.ascontiguousarray(pc[:, 3])
        tree = native.KdTree(pts, self.num_threads)
        normals = covs = None
        if self.registration_type in ("PLANE_ICP", "GICP", "COLORED_ICP"):
            normals, covs = tree.estimate_normals_covariances(
                self.knn, self.num_threads)

        if self.previous_pcd is None:
            self.previous_pcd = pts
            self.previous_tree = tree
            self.previous_normals = normals
            self.previous_covs = covs
            self.previous_colors = colors
            self.T_world_camera = (
                init_gt_pose if init_gt_pose is not None else np.eye(4))
            return self.T_world_camera

        init = T_last_current if T_last_current is not None else np.eye(4)
        if self.registration_type == "COLORED_ICP":
            if colors is None or self.previous_colors is None:
                raise ValueError("COLORED_ICP needs (N, 4+) points w/ colors")
            res = native.align_colored(
                self.previous_pcd, pts, self.previous_colors, colors,
                target_tree=self.previous_tree,
                init_T_target_source=init,
                max_correspondence_distance=self.max_corresponding_distance,
                num_threads=self.num_threads,
                max_iterations=self.max_iterations, knn=self.knn,
            )
        else:
            res = native.align(
                self.previous_pcd,
                pts,
                target_tree=self.previous_tree,
                init_T_target_source=init,
                max_correspondence_distance=self.max_corresponding_distance,
                registration_type=self.registration_type,
                num_threads=self.num_threads,
                max_iterations=self.max_iterations,
                knn=self.knn,
                target_normals=self.previous_normals,
                target_covs=self.previous_covs,
                source_covs=covs,
            )
        self.T_world_camera = self.T_world_camera @ res.T_target_source
        self.previous_pcd = pts
        self.previous_tree = tree
        self.previous_normals = normals
        self.previous_covs = covs
        self.previous_colors = colors
        return self.T_world_camera

    def align_hybrid(
        self,
        rgb: np.ndarray,  # (H, W, 3) in [0, 1]
        depth: np.ndarray,  # (H, W) meters
        K: np.ndarray,
        init_gt_pose: np.ndarray | None = None,
        T_last_current: np.ndarray | None = None,
    ) -> np.ndarray:
        """Dense hybrid RGB-D odometry path (reference align_o3d_hybrid,
        tracker.py:211-252): multi-scale photometric + geometric GN on the
        tracker's device (tracking/odometry.py)."""
        from .odometry import rgbd_odometry_multi_scale

        if self.last_rgbd is None:
            self.last_rgbd = (rgb, depth)
            self.T_world_camera = (
                init_gt_pose if init_gt_pose is not None else np.eye(4))
            return self.T_world_camera
        prev_rgb, prev_depth = self.last_rgbd
        rel = rgbd_odometry_multi_scale(
            rgb, depth, prev_rgb, prev_depth, K,
            init_T=(T_last_current if T_last_current is not None
                    else np.eye(4)),
            device=self.device,
        )
        self.T_world_camera = self.T_world_camera @ rel
        self.last_rgbd = (rgb, depth)
        return self.T_world_camera


class ICPExperiment:
    """Run Scan2ScanICP over a dataset, logging per-frame eT/eR against the
    ground truth (reference eval/experiment.py:62-149: per-frame GT init —
    measures the per-frame alignment error). The clouds are back-projected
    on `device`, where HYBRID also runs; the registrations run on the
    host."""

    def __init__(
        self,
        dataset,
        registration_type: str = "GICP",
        run_dir: str | Path = "runs/icp",
        voxel_res: float = 0.0,
        knn: int = 20,
        max_images: int = 2000,
        device="cuda",
    ):
        self.dataset = dataset
        self.device = resolve_device(device)
        self.tracker = Scan2ScanICP(
            registration_type=registration_type,
            voxel_downsampling_resolution=voxel_res,
            knn=knn,
            device=str(self.device),
        )
        self.max_images = max_images
        self.logger = ExperimentLogger(
            run_dir,
            config=dict(
                algorithm=registration_type, dataset=str(dataset), knn=knn,
                device=str(self.device),
            ),
        )

    def run(self):
        eTs, eRs = [], []
        n = min(len(self.dataset), self.max_images)
        rtype = self.tracker.registration_type
        for i in range(n):
            frame = self.dataset[i]
            pose_gt = frame.c2w.astype(np.float64)
            # per-frame GT init (reference experiment.py:86-110): the world
            # pose is reset to the CURRENT frame's GT each frame and
            # T_last_current starts at identity. This is the reference's
            # protocol verbatim (pre_pose and pose_gt both read frame i):
            # the composed est = gt_i @ T_rel, so even a PERFECT
            # registration reports eT/eR of the one-frame relative motion;
            # the reference's published ICP baselines measure exactly this.
            self.tracker.T_world_camera = pose_gt
            if rtype == "HYBRID":
                est = self.tracker.align_hybrid(
                    np.asarray(frame.rgb, np.float64) / 255.0,
                    np.asarray(frame.depth, np.float64), frame.K,
                    init_gt_pose=pose_gt, T_last_current=np.eye(4),
                )
            else:
                pts = depth_to_points(as_f32(frame.depth, self.device),
                                      as_f32(frame.K, self.device))
                pts = pts.cpu().numpy().astype(np.float64)
                if rtype == "COLORED_ICP":
                    # xyz + intensity (reference experiment.py:92-100)
                    inten = (np.asarray(frame.rgb, np.float64)
                             .mean(-1).reshape(-1, 1) / 255.0)
                    pts = np.concatenate([pts, inten], axis=1)
                est = self.tracker.align(pts, init_gt_pose=pose_gt,
                                         T_last_current=np.eye(4))
            if i == 0:
                continue
            # the metric helpers of SequenceRunner's eT/eR, so ICP and
            # gsplat tables stay comparable
            eT = float(translation_error(
                torch.as_tensor(est, dtype=torch.float32),
                torch.as_tensor(pose_gt, dtype=torch.float32)))
            eR = float(rotation_error_deg(est, pose_gt))
            eTs.append(eT)
            eRs.append(eR)
            self.logger.log(i, eT=eT, eR=eR)
        self.logger.log(n, ate_rmse=rmse(eTs), aae_rmse=rmse(eRs))
        self.logger.finish()
        return {"eT": eTs, "eR": eRs, "ate_rmse": rmse(eTs),
                "aae_rmse": rmse(eRs)}


def run_icp_sweep(
    dataset_factory,
    scenes: list[str],
    methods: list[str] = ("ICP", "PLANE_ICP", "GICP"),
    run_root: str | Path = "runs/icp_sweep",
    ledger_path: str | Path | None = None,
    max_images: int = 2000,
    device="cuda",
):
    """Sweep methods x scenes with a JSONL resume ledger (reference
    icps_eval.py:12-23,52-60: finished configs are skipped on a re-run; one
    failure does not end the sweep). Returns {(scene, method): result}."""
    device = resolve_device(device)  # raises here, not once per config
    run_root = Path(run_root)
    ledger_path = Path(ledger_path or run_root / "finished.jsonl")
    ledger_path.parent.mkdir(parents=True, exist_ok=True)
    finished = set()
    if ledger_path.exists():
        for line in ledger_path.read_text().splitlines():
            if line.strip():
                rec = json.loads(line)
                finished.add((rec["scene"], rec["method"]))

    results = {}
    for scene in scenes:
        for method in methods:
            if (scene, method) in finished:
                continue
            ds = None
            try:
                ds = dataset_factory(scene)
                exp = ICPExperiment(
                    ds, registration_type=method,
                    run_dir=run_root / f"{scene}_{method}",
                    max_images=max_images, device=device,
                )
                out = exp.run()
                results[(scene, method)] = out
                with open(ledger_path, "a") as f:
                    f.write(json.dumps({
                        "scene": scene, "method": method,
                        "ate_rmse": out["ate_rmse"],
                        "aae_rmse": out["aae_rmse"], "ts": time.time(),
                    }) + "\n")
            except Exception as e:  # keep the sweep alive (icps_eval.py:80-84)
                print(f"sweep {scene}/{method} failed: {e}")
            finally:
                if hasattr(ds, "close"):  # a fixture's render workers
                    ds.close()
    return results
