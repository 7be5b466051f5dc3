"""Replica and TUM RGB-D dataset loaders.

Behavioral parity with reference src/data/dataset.py:
  * Replica (:78-161): jpg color + 16-bit png depth / scale (cam_params.json),
    poses from traj.txt (4x4 per row), natural-sorted frame*/depth* files.
  * TUM (:164-321): timestamp association of rgb/depth/groundtruth within
    max_dt=0.08, frame-rate subsampling, quaternion poses, first pose
    normalized to identity, undistortion + edge crop. PNGs are decoded by
    `png.py` and colour undistorted by `undistort.py` (numpy, no OpenCV).
  * Replica decodes its JPEG colour with OpenCV.
Also a Synthetic box-room dataset so the full pipeline runs with no data on
disk (the reference has no such thing; tests/benches need it).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from . import png
from .base import RGBDFrame, as_intrinsics_matrix, load_camera_cfg, natsorted
from .undistort import undistort


class DatasetIndexError(IndexError, ValueError):
    """Out-of-range dataset index (both IndexError for the Sequence
    protocol and ValueError for reference parity)."""


class BaseDataset(Sequence):
    """Sequence[RGBDFrame] with camera config handling (reference :17-75)."""

    def __init__(self, input_folder: str | Path, cfg_file: str | Path):
        self.input_folder = Path(input_folder)
        if not self.input_folder.exists():
            raise FileNotFoundError(f"dataset folder {input_folder} missing")
        self._init_camera(load_camera_cfg(cfg_file)["camera"])

    def _init_camera(self, cfg: dict):
        """Scale, distortion, crop and intrinsics from a camera config block
        (the "camera" object of cam_params.json)."""
        self.cfg = cfg
        self.scale = self.cfg["scale"]
        self.distortion = (
            np.array(self.cfg["distortion"]) if "distortion" in self.cfg else None
        )
        self.crop_edge = self.cfg.get("crop_edge", 0)
        # calibrated (pre-crop) intrinsics: undistortion runs on the FULL
        # image before cropping, so it must use the calibration principal
        # point, not the crop-shifted one (reference dataset.py:221-231)
        self.K_raw = as_intrinsics_matrix(
            self.cfg["fx"], self.cfg["fy"], self.cfg["cx"], self.cfg["cy"]
        )
        if self.crop_edge:
            self.cfg["h"] -= 2 * self.crop_edge
            self.cfg["w"] -= 2 * self.crop_edge
            self.cfg["cx"] -= self.crop_edge
            self.cfg["cy"] -= self.crop_edge
        self.K = as_intrinsics_matrix(
            self.cfg["fx"], self.cfg["fy"], self.cfg["cx"], self.cfg["cy"]
        )

    def __len__(self):
        raise NotImplementedError

    def _get_one(self, index: int) -> RGBDFrame:
        raise NotImplementedError

    def __getitem__(self, index):
        if isinstance(index, int):
            if index < 0 or index >= len(self):
                # IndexError keeps Sequence mixins working (__iter__,
                # __contains__, reversed terminate on it); ValueError
                # preserves the reference's contract (dataset.py:45-54)
                raise DatasetIndexError(
                    f"index {index} out of range (0 to {len(self)-1})")
            return self._get_one(index)
        if isinstance(index, slice):
            return [self._get_one(i) for i in range(*index.indices(len(self)))]
        raise TypeError(f"index must be int or slice, got {type(index)}")


class Replica(BaseDataset):
    ROOMS = ["room0", "room1", "room2", "office0", "office1", "office2",
             "office3", "office4"]

    def __init__(
        self,
        name: str = "room0",
        *,
        root: str | Path = "datasets/Replica",
    ):
        root = Path(root)
        self.name = name
        super().__init__(root / name, root / "cam_params.json")
        self._color_paths = natsorted(self.input_folder.rglob("frame*.jpg"))
        self._depth_paths = natsorted(self.input_folder.rglob("depth*.png"))
        if not self._depth_paths:
            # float-depth variant (no uint16 quantization): 32-bit float
            # TIFFs, written by scripts/make_replica_fixture.py
            # --float-depth for the depth-quantization accuracy A/B; the
            # real dataset always ships png (reference dataset.py:149-161)
            self._depth_paths = natsorted(self.input_folder.rglob("depth*.tiff"))
        if not self._color_paths or len(self._color_paths) != len(self._depth_paths):
            raise FileNotFoundError(f"no/mismatched frames under {self.input_folder}")
        self._poses = self._load_poses()

    def __str__(self):
        return f"Replica dataset: {self.name}\n in {self.input_folder}"

    def __len__(self):
        return len(self._color_paths)

    def _load_poses(self):
        lines = (self.input_folder / "traj.txt").read_text().splitlines()
        return [
            np.array([float(v) for v in line.split()]).reshape(4, 4)
            for line in lines[: len(self)]
        ]

    def _get_one(self, index: int) -> RGBDFrame:
        import cv2

        bgr = cv2.imread(str(self._color_paths[index]), cv2.IMREAD_COLOR)
        # NOTE parity: the reference does NOT convert Replica BGR->RGB
        # (dataset.py:127-131) — colors are only used as SH DC values, and
        # the loss is depth-only, so we keep faithful channel order.
        rgb = bgr.astype(np.float64)
        depth = cv2.imread(str(self._depth_paths[index]), cv2.IMREAD_UNCHANGED)
        depth = depth.astype(np.float64) / self.scale
        return RGBDFrame(rgb=rgb, depth=depth, K=self.K,
                         c2w=self._poses[index].astype(np.float32))


class TUM(BaseDataset):
    SCENES = [
        "freiburg1_desk", "freiburg1_desk2", "freiburg1_room",
        "freiburg2_xyz", "freiburg3_long_office_household",
    ]

    def __init__(
        self,
        name: str = "freiburg1_desk",
        *,
        root: str | Path = "datasets/TUM",
        frame_rate: int = 32,
    ):
        self.name = "rgbd_dataset_" + name
        data_dir = Path(root) / self.name
        super().__init__(data_dir, data_dir / "cam_params.json")
        self._color_paths, self._depth_paths, self._poses = self._load_tum(frame_rate)

    def __str__(self):
        return f"TUM dataset: {self.name}\n in {self.input_folder}"

    def __len__(self):
        return len(self._color_paths)

    def _load_tum(self, frame_rate: int):
        d = self.input_folder
        pose_list = d / ("groundtruth.txt" if (d / "groundtruth.txt").is_file()
                         else "pose.txt")
        image_data = np.loadtxt(d / "rgb.txt", delimiter=" ", dtype=np.str_)
        depth_data = np.loadtxt(d / "depth.txt", delimiter=" ", dtype=np.str_)
        pose_data = np.loadtxt(pose_list, delimiter=" ", dtype=np.str_, skiprows=1)
        pose_vecs = pose_data[:, 1:].astype(np.float64)
        t_img = image_data[:, 0].astype(np.float64)
        t_dep = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)

        assoc = self._associate(t_img, t_dep, t_pose)
        indices = [0]
        for i in range(1, len(assoc)):
            t0 = t_img[assoc[indices[-1]][0]]
            t1 = t_img[assoc[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indices.append(i)

        colors, depths, poses = [], [], []
        inv_first = None
        for ix in indices:
            i, j, k = assoc[ix]
            colors.append(d / str(image_data[i, 1]))
            depths.append(d / str(depth_data[j, 1]))
            c2w = self._pose_from_quat(pose_vecs[k])
            if inv_first is None:
                inv_first = np.linalg.inv(c2w)
                c2w = np.eye(4)
            else:
                c2w = inv_first @ c2w
            poses.append(c2w.astype(np.float32))
        return colors, depths, poses

    @staticmethod
    def _associate(t_img, t_dep, t_pose, max_dt: float = 0.08):
        assoc = []
        for i, t in enumerate(t_img):
            j = int(np.argmin(np.abs(t_dep - t)))
            k = int(np.argmin(np.abs(t_pose - t)))
            if abs(t_dep[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
                assoc.append((i, j, k))
        return assoc

    @staticmethod
    def _pose_from_quat(pvec: np.ndarray) -> np.ndarray:
        from scipy.spatial.transform import Rotation

        pose = np.eye(4)
        pose[:3, :3] = Rotation.from_quat(pvec[3:]).as_matrix()  # xyzw
        pose[:3, 3] = pvec[:3]
        return pose

    def _get_one(self, index: int) -> RGBDFrame:
        bgr = png.imread(self._color_paths[index])
        if bgr.ndim == 2:  # IMREAD_COLOR's grey -> BGR
            bgr = np.repeat(bgr[..., None], 3, axis=-1)
        bgr = bgr[..., :3]  # and its alpha drop
        if self.distortion is not None:
            bgr = undistort(bgr, self.K_raw, self.distortion)
        rgb = bgr[..., ::-1].astype(np.float64)
        depth = png.imread(self._depth_paths[index]).astype(np.float32)
        ce = self.crop_edge
        if ce > 0:
            rgb = rgb[ce:-ce, ce:-ce]
            depth = depth[ce:-ce, ce:-ce]
        return RGBDFrame(rgb=rgb, depth=depth / self.scale, K=self.K,
                         c2w=self._poses[index])


class SyntheticBoxRoom(BaseDataset):
    """Analytic box-room sequence — runs the full pipeline with no files."""

    def __init__(self, n_frames: int = 40, height: int = 120, width: int = 160,
                 seed: int = 0, speed: float = 1.0, clutter: int = 0,
                 boxes: int = 0):
        from .synthetic import box_room_trajectory

        self.cfg = {"fx": width * 0.6, "fy": width * 0.6,
                    "cx": width / 2 - 0.5, "cy": height / 2 - 0.5, "scale": 1.0}
        self.scale = 1.0
        self.crop_edge = 0
        self.distortion = None
        self.K = as_intrinsics_matrix(
            self.cfg["fx"], self.cfg["fy"], self.cfg["cx"], self.cfg["cy"]
        )
        self.name = f"boxroom{n_frames}"
        self.input_folder = Path("<synthetic>")
        self._h, self._w = height, width
        self._poses = box_room_trajectory(n_frames, seed, speed)
        self._clutter = clutter
        self._boxes = boxes

    def __str__(self):
        return f"Synthetic box room ({len(self)} frames)"

    def __len__(self):
        return len(self._poses)

    def _get_one(self, index: int) -> RGBDFrame:
        from .synthetic import box_room_frame

        rgb, depth = box_room_frame(self._poses[index], self.K, self._h, self._w,
                                    clutter=self._clutter, boxes=self._boxes)
        return RGBDFrame(rgb=rgb * 255.0, depth=depth, K=self.K,
                         c2w=self._poses[index])


def get_dataset(name: str, scene: str, **kwargs):
    """Factory (reference get_data_set, dataset.py:324-330), plus the
    file-less sources "Synthetic" and "ReplicaFixture"."""
    if name == "Replica":
        return Replica(scene, **kwargs)
    if name == "TUM":
        return TUM(scene, **kwargs)
    if name == "Synthetic":
        return SyntheticBoxRoom(**kwargs)
    if name == "ReplicaFixture":
        from .fixtures import ReplicaFixture

        return ReplicaFixture(scene, **kwargs)
    raise ValueError("dataset name should be in ['TUM', 'Replica', "
                     "'Synthetic', 'ReplicaFixture']")
