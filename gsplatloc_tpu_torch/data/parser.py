"""Frame-pair assembler: world transform + PCA normalization + depth-GT
re-rendering, producing AlignData for the tracking loop.

  parser[i] -> (tar = frame i, src = frame i+1):
    * BOTH camera-frame clouds go to world with TAR's pose,
    * PCA principal-axis normalization from tar's cloud, applied to both
      clouds and both poses,
    * the pair's GT depth is NOT the raw sensor depth: the src cloud is
      re-rendered as throwaway opacity-1 Gaussians from the (normalized)
      tar viewpoint, divided by the pca factor — so rendered and target
      depth share representation artifacts.

Entry points run on the CUDA device by default and raise when none is
present; pass device="cpu" for the plain PyTorch path.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, as_f32, resolve_device
from ..models.gaussians import scene_from_point_cloud
from ..ops.camera import depth_to_points
from ..ops.lie import invert_se3, transform_points
from ..ops.pca import normalize_pair
from .base import AlignData
from .datasets import get_dataset


def render_depth_gt(
    points,  # (N, 3) world
    rgbs,  # (N, 3)
    K,
    c2w,
    height: int,
    width: int,
    grid_shape=None,  # (H, W) if grid-ordered
    backend: str = "subtile",
    knn_sq_dists=None,  # precomputed (N, k)
    device=DEFAULT_DEVICE,
) -> torch.Tensor:
    """Throwaway scene (opacity 1, kNN scales with the squared-distance
    quirk, identity quats) rendered to depth, no grad. Returns (H, W).

    backend "subtile" renders through the sub-tile forward walk — the same
    kernel family as the tracking render, so representation artifacts
    cancel in the loss — with exact big-splat binning. The other backends
    of the reference (general rasterizer, full-tile) are later slices."""
    if backend != "subtile":
        raise NotImplementedError(
            f"render_depth_gt(backend={backend!r}): only 'subtile' is ported")
    from ..ops.fused_subtile import (
        build_subtile_slot_buffer,
        render_tracking_depth_subtile,
    )

    dev = resolve_device(device)
    with torch.no_grad():
        scene = scene_from_point_cloud(points, rgbs, grid_shape=grid_shape,
                                       knn_sq_dists=knn_sq_dists, device=dev)
        K = as_f32(K, dev)
        vm = invert_se3(as_f32(c2w, dev))
        slot, meta, _ = build_subtile_slot_buffer(
            scene, vm, K, width, height, 1e-2, 1e10)
        depth, _alpha = render_tracking_depth_subtile(
            vm, K, width, height, slot, meta)
    return depth


def _assemble_pair(
    tar_rgb, tar_depth, tar_c2w, src_rgb, src_depth, src_c2w, K,
    height: int, width: int, normalize: bool = True, backend: str = "subtile",
    src_knn_sq_dists=None, device=DEFAULT_DEVICE,
):
    dev = resolve_device(device)
    tar_rgb, tar_depth, tar_c2w, src_rgb, src_depth, src_c2w, K = (
        as_f32(a, dev) for a in
        (tar_rgb, tar_depth, tar_c2w, src_rgb, src_depth, src_c2w, K))
    with torch.no_grad():
        tar_points = transform_points(tar_c2w, depth_to_points(tar_depth, K))
        src_points = transform_points(tar_c2w, depth_to_points(src_depth, K))
        tar_colors = tar_rgb.reshape(-1, 3) / 255.0

        pca_factor = torch.ones((), dtype=torch.float32, device=dev)
        if normalize:
            tar_points, src_points, tar_c2w, src_c2w, pca_factor = (
                normalize_pair(tar_points, src_points, tar_c2w, src_c2w))
            src_colors = src_rgb.reshape(-1, 3) / 255.0
            depth_gt = (
                render_depth_gt(
                    src_points, src_colors, K, tar_c2w, height, width,
                    grid_shape=(height, width), backend=backend,
                    knn_sq_dists=src_knn_sq_dists, device=dev,
                )
                / pca_factor
            )
        else:
            depth_gt = src_depth

    return dict(
        colors=tar_colors,
        pixels=src_rgb / 255.0,
        tar_points=tar_points,
        src_points=src_points,
        src_depth=depth_gt,
        tar_c2w=tar_c2w,
        src_c2w=src_c2w,
        pca_factor=pca_factor,
    )


class Parser:
    """parser[i] -> AlignData for the (i, i+1) frame pair."""

    def __init__(
        self,
        data_set: str = "Replica",
        name: str = "room0",
        normalize: bool = True,
        backend: str = "subtile",
        knn_method: str = "auto",
        device=DEFAULT_DEVICE,
        **dataset_kwargs,
    ):
        self.device = resolve_device(device)
        self._data = get_dataset(data_set, name, **dataset_kwargs)
        self.K = as_f32(self._data.K, self.device)
        self.normalize = normalize
        self.backend = backend
        # "exact": the depth-target scene's scale-init kNN comes from the
        # host KdTree over the raw src cloud (rigid-invariant, so it
        # composes with the world/PCA transforms); any other method is
        # computed where the scene is built
        self.knn_method = knn_method
        self._knn_cache = {}  # frame index -> (N, 5) sq dists (last 3)
        self._frame_cache = {}  # frame index -> RGBDFrame (last 3)

    def frame(self, index: int):
        """self._data[index] with a 3-frame decode cache: sequential
        tracking reads each frame twice (as src of pair i-1, then tar of
        pair i) and a prefetching runner reads one pair ahead — caching 3
        frames makes every image decode exactly once."""
        if index not in self._frame_cache:
            self._frame_cache[index] = self._data[index]
            for k in sorted(self._frame_cache)[:-3]:
                del self._frame_cache[k]
        return self._frame_cache[index]

    def knn_for_frame(self, index: int):
        """Exact scale-init kNN sq-dists (N, 5) of frame `index`'s raw cloud
        (None unless knn_method == "exact"). Cached for three frames: pair
        i's tar is pair i-1's src, so sequential tracking computes each
        frame once, and a prefetching runner's pair i+1 never evicts pair
        i's frames. Host work only (numpy back-projection + the C++ tree),
        so a prefetch worker can run it while the card is busy."""
        if self.knn_method != "exact":
            return None
        if index not in self._knn_cache:
            from ..ops.knn import exact_knn_sq_dists

            frame = self.frame(index)
            depth = np.asarray(frame.depth, np.float32)
            K = np.asarray(self._data.K, np.float32)
            h, w = depth.shape
            u = np.arange(w, dtype=np.float32)[None, :]
            v = np.arange(h, dtype=np.float32)[:, None]
            x = (u - K[0, 2]) / K[0, 0] * depth
            y = (v - K[1, 2]) / K[1, 1] * depth
            cam_pts = np.stack([x, y, depth], axis=-1).reshape(-1, 3)
            self._knn_cache[index] = exact_knn_sq_dists(cam_pts, 5)
            for k in sorted(self._knn_cache)[:-3]:
                del self._knn_cache[k]
        return self._knn_cache[index]

    def __len__(self):
        return len(self._data) - 1

    @property
    def dataset(self):
        return self._data

    def __getitem__(self, index: int) -> AlignData:
        if not 0 <= index < len(self._data) - 1:
            raise IndexError(f"pair index {index} out of range")
        return self.pair_from_frames(self.frame(index), self.frame(index + 1),
                                     self.knn_for_frame(index + 1))

    def pair_from_frames(self, tar, src, src_knn=None) -> AlignData:
        """AlignData of the pair (tar, src) of decoded frames on the
        parser's device; src_knn: the src cloud's precomputed scale-init
        kNN (`knn_for_frame`), or None."""
        h, w = src.hw
        out = _assemble_pair(
            tar.rgb, tar.depth, tar.c2w, src.rgb, src.depth, src.c2w, self.K,
            height=h, width=w, normalize=self.normalize, backend=self.backend,
            src_knn_sq_dists=src_knn, device=self.device,
        )
        return AlignData(tar_nums=out["tar_points"].shape[0], **out)
