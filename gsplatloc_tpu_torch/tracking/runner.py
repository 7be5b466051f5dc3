"""Full-sequence pose tracking runner.

For each frame pair (i, i+1): build the frozen Gaussian scene from the tar
cloud, start the camera at tar's (normalized) pose, run the early-stopped
pose optimization (opt/tracking.py) and record eT/eR of the best-loss
pose against src's (normalized) pose.

A 3-stage pipeline over pairs: prepare | optimize | collect. With prefetch
on, a worker thread runs the HOST part of prepare (image decode and the
exact kNN over the C++ KdTree) for the next pairs while the main thread
works on the current one. Everything that touches the card — pair
assembly, the depth-target render, the scene build, the optimization —
stays on the main thread: a second thread enqueuing work on the same
stream would race the main thread's launches and the kernels' launch
counters. Results are bitwise equal with and without prefetch.

Each stage is a span of utils/profiling.py (`gsl.pair` around a pair,
`gsl.wait`, `gsl.parse`, `gsl.scene`, `gsl.optimize`, `gsl.collect` inside
it, `gsl.decode` and `gsl.knn` on the worker, each tagged with its pair
index); their host seconds fill `SequenceResult.stage_s`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device
from ..data.parser import Parser
from ..eval.logger import ExperimentLogger
from ..eval.metrics import rmse, rotation_error_deg, translation_error
from ..models.gaussians import scene_from_point_cloud
from ..opt.tracking import TrackingConfig, optimize_pose
from ..utils.profiling import span

# pairs whose host prepare the prefetch worker runs ahead of the main thread
PREFETCH_DEPTH = 2


@dataclass
class SequenceResult:
    eT: list = field(default_factory=list)  # meters, per pair
    eR: list = field(default_factory=list)  # degrees, per pair
    losses: list = field(default_factory=list)
    steps: list = field(default_factory=list)
    rebuilds: list = field(default_factory=list)
    selects: list = field(default_factory=list)
    clamped_scales: list = field(default_factory=list)  # clamped_count
    slot_overflow: list = field(default_factory=list)  # 0 / 1
    poses_est: list = field(default_factory=list)  # (4,4) per pair
    wall_s: float = 0.0
    # cumulative per-stage wall clock (seconds over the whole run), one
    # key per span of the same name:
    #   decode / knn — host prepare (on the prefetch worker when prefetch
    #     is on, so their sum can exceed what they cost on the critical
    #     path);
    #   parse / scene — pair assembly with the depth-target render, and
    #     the scene build (main thread, on the device);
    #   wait — main-thread time blocked on the prefetch worker (the part
    #     of host prepare the pipeline did not hide);
    #   optimize — main-thread time in optimize_pose;
    #   collect — host readout + logging, figures and checkpoints;
    #   step / render / loss / backward / adam / read / rebuild / select —
    #     optimize_pose's own spans (PairResult.host_s), inside optimize.
    # Beside the seconds it holds three counts, summed over the pairs:
    #   launched — the steps optimize_pose enqueued (>= sum(steps));
    #   segments — its host reads, one a segment;
    #   replayed — the launched steps served by CUDA graph replays.
    # (stage_s is the one record the benchmark sums key by key.)
    stage_s: dict = field(default_factory=dict)

    @property
    def ate_rmse(self) -> float:
        return rmse(self.eT)

    @property
    def aae_rmse(self) -> float:
        return rmse(self.eR)

    @property
    def pose_steps_per_s(self) -> float:
        return float(np.sum(self.steps) / self.wall_s) if self.wall_s else 0.0


def clamped_count(knn_sq_dists) -> int:
    """The splats the scale-init clamp caps in a frame's scene, from its
    exact kNN squared distances (N, k): raw scales over float64 against
    the float32 0.99-quantile times 64 (0 on healthy scenes)."""
    neigh = knn_sq_dists.numpy()[:, 1:].astype(np.float64)
    s_raw = np.sqrt(np.mean(neigh**2, axis=-1) + 1e-24)
    cap = np.quantile(s_raw.astype(np.float32), 0.99) * 64.0
    return int((s_raw > cap).sum())


class SequenceRunner:
    """Track a whole RGB-D sequence frame-to-frame on `device`."""

    def __init__(
        self,
        data_set: str = "Replica",
        scene_name: str = "room0",
        normalize: bool = True,
        config: TrackingConfig | None = None,
        backend: str = "fused",
        run_dir: str | Path = "runs/default",
        max_pairs: int = 1998,
        algorithm: str = "gsplatloc_tpu",
        panel_every: int = 0,
        pcd_every: int = 0,
        knn_method: str = "auto",  # scale-init kNN: auto|grid|exact|brute
        device=DEFAULT_DEVICE,
        **dataset_kwargs,
    ):
        if panel_every > 0 or pcd_every > 0:
            # the figures are drawn with matplotlib: raise here, naming it,
            # not at the first pair that writes one
            from ..eval.visualize import _mpl

            _mpl()
        self.panel_every = panel_every
        self.pcd_every = pcd_every
        cfg = config or TrackingConfig()
        # the depth target is rendered through the same kernel family as
        # the tracking render, so representation artifacts cancel
        if backend in ("pallas", "reference"):
            parser_backend = backend
        elif backend != "fused":
            raise ValueError(f"unknown backend {backend!r}")
        else:
            parser_backend = "subtile" if cfg.subtile else "fused"
        self.device = resolve_device(device)
        # "auto" -> EXACT KdTree scale init (the grid-window approximation
        # inflates grazing depth-edge scales into image-wide opaque blobs);
        # a library that cannot be built raises here instead of falling
        # back to the grid window
        if knn_method == "auto":
            from .. import native

            native.build_library()
            knn_method = "exact"
        self.knn_method = knn_method
        self.parser = Parser(
            data_set=data_set, name=scene_name, normalize=normalize,
            backend=parser_backend, knn_method=knn_method, device=self.device,
            **dataset_kwargs,
        )
        self.config = cfg
        self.backend = backend
        self.max_pairs = max_pairs
        self.logger = ExperimentLogger(
            run_dir,
            config=dict(
                dataset=data_set, scene=scene_name, normalize=normalize,
                backend=backend, algorithm=algorithm, knn_method=knn_method,
                device=str(self.device), **self.config._asdict(),
            ),
        )

    def _prepare_host(self, i: int):
        """Host part of pair i's prepare: decode both frames, then the exact
        kNN of both raw clouds (cached per frame by the parser). Touches
        no device. Returns (tar, src, knn_tar, knn_src, stages)."""
        stages = {}
        with span("gsl.decode", stages, args=i):
            tar = self.parser.frame(i)
            src = self.parser.frame(i + 1)
        with span("gsl.knn", stages, args=i):
            knn_tar = self.parser.knn_for_frame(i)
            knn_src = self.parser.knn_for_frame(i + 1)
        # observability of the scale-init robust clamp: the number of
        # splats it caps (0 on healthy scenes)
        if knn_tar is not None:
            stages["clamped"] = clamped_count(knn_tar)
        return tar, src, knn_tar, knn_src, stages

    def _prepare_device(self, host):
        """Device part of the prepare: pair assembly (world transform, PCA
        normalization, the depth-target render) and the scene build."""
        tar, src, knn_tar, knn_src, stages = host
        with span("gsl.parse", stages):
            h, w = src.hw
            data = self.parser.pair_from_frames(tar, src, knn_src)
            self._sync()
        with span("gsl.scene", stages):
            scene = scene_from_point_cloud(
                data.tar_points, data.colors, grid_shape=(h, w),
                knn_sq_dists=knn_tar, knn_method=self.knn_method,
                device=self.device,
            )
            self._sync()
        return data, scene, (h, w), stages

    def _sync(self):
        """Wait for the card, so a stage's wall clock holds its device work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _collect_pair(self, i, data, out, res: SequenceResult, progress: bool,
                      t_start: float, wall_base: float,
                      checkpoint_every: int):
        """Host readout + bookkeeping of one optimized pair: ONE device ->
        host copy covers every value the host needs."""
        from ..utils.checkpoint import save_checkpoint

        host = torch.cat([
            out.best_pose.to_c2w().reshape(-1), data.src_c2w.reshape(-1),
            out.best_loss.reshape(1),
        ]).cpu().numpy()
        best_c2w = host[:16].reshape(4, 4)
        src_c2w = host[16:32].reshape(4, 4)
        best_loss = float(host[32])
        if out.slot_overflow:
            # a truncated cover silently degrades the highest sub-tiles'
            # accuracy — surface it loudly
            print(f"[runner] WARNING pair {i}: slot_budget overflow — "
                  f"cover truncated; raise TrackingConfig.slot_budget",
                  flush=True)
            self.logger.log(i, slot_overflow=1)
        eT = float(translation_error(best_c2w, src_c2w))
        eR = float(rotation_error_deg(best_c2w, src_c2w))
        res.eT.append(eT)
        res.eR.append(eR)
        res.losses.append(best_loss)
        res.steps.append(int(out.steps_run))
        res.rebuilds.append(int(out.rebuilds))
        res.selects.append(int(out.selects))
        res.slot_overflow.append(int(bool(out.slot_overflow)))
        res.poses_est.append(best_c2w)
        self.logger.log(
            i, eT=eT, eR=eR, best_loss=best_loss,
            steps=int(out.steps_run), rebuilds=int(out.rebuilds),
            selects=int(out.selects),
        )
        if self.panel_every and i % self.panel_every == 0:
            self._write_panel(i, data, best_c2w, eT, eR, int(out.steps_run))
        if self.pcd_every and i % self.pcd_every == 0:
            self._write_pcd(i, data, best_c2w, src_c2w, eT, eR)
        if checkpoint_every and (i + 1) % checkpoint_every == 0:
            save_checkpoint(
                self.logger.run_dir, i + 1, res.poses_est, res.eT,
                res.eR, res.losses, res.steps,
                extra={"wall_s": wall_base + time.time() - t_start},
            )
        if progress:
            print(f"[track] pair {i}: eT={eT * 100:.4f}cm eR={eR:.4f}deg "
                  f"steps={int(out.steps_run)}", flush=True)

    def _write_panel(self, i, data, best_c2w, eT, eR, steps):
        """RGBD comparison panel of pair i: src's depth against the depth
        rendered at the best pose through the depth target's kernel
        family."""
        from ..data.parser import render_depth_gt
        from ..eval.visualize import plot_rgbd_panel

        h, w = data.src_depth.shape
        d_best = render_depth_gt(
            data.tar_points, data.colors, self.parser.K, best_c2w, h, w,
            grid_shape=(h, w), backend=self.parser.backend,
            device=self.device)
        plot_rgbd_panel(
            data.src_depth.cpu().numpy(), d_best.cpu().numpy(),
            self.logger.run_dir / "panels" / f"pair_{i:05d}.png",
            title=(f"pair {i}: eT={eT*100:.4f}cm eR={eR:.4f}deg "
                   f"steps={steps}"),
        )

    def _write_pcd(self, i, data, best_c2w, src_c2w, eT, eR):
        """3D inspection PNG of pair i: the (normalized) tar cloud, every
        8th point, and the tar / src GT / estimated camera frusta."""
        from ..eval.visualize import visualize_point_cloud

        h, w = data.src_depth.shape
        visualize_point_cloud(
            data.tar_points[::8].cpu().numpy(),
            self.logger.run_dir / "pcd" / f"pair_{i:05d}.png",
            colors=data.colors[::8].cpu().numpy(),
            poses={"tar": data.tar_c2w.cpu().numpy(), "src GT": src_c2w,
                   "est": best_c2w},
            K=self.parser.K.cpu().numpy(), wh=(w, h),
            title=(f"pair {i} (normalized frame): eT={eT*100:.4f}cm "
                   f"eR={eR:.4f}deg"),
        )

    def train(self, progress: bool = True, resume: bool = False,
              checkpoint_every: int = 50,
              prefetch: bool = True) -> SequenceResult:
        """Run the sequence. With prefetch=True (default) a single worker
        runs the host prepare of the next PREFETCH_DEPTH pairs, in order,
        while the main thread prepares on the device, optimizes and
        collects; pair i's readout waits until pair i+1 is optimized. The
        results are bitwise equal to prefetch=False, the strictly serial
        loop."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        from ..utils.checkpoint import load_checkpoint

        res = SequenceResult()
        start_pair = 0
        # wall time that earlier runs spent on the checkpointed pairs
        wall_base = 0.0
        if resume:
            start_pair, state = load_checkpoint(self.logger.run_dir)
            if state is not None:
                res.poses_est = state["poses_est"]
                res.eT = state["eT"]
                res.eR = state["eR"]
                res.losses = state["losses"]
                res.steps = [int(s) for s in state["steps"]]
                wall_base = float(state.get("wall_s", 0.0))
        t_start = time.time()
        n_pairs = min(len(self.parser), self.max_pairs)
        executor = ThreadPoolExecutor(max_workers=1) if prefetch else None
        depth = PREFETCH_DEPTH
        try:
            futs = deque()
            if prefetch:
                for j in range(start_pair,
                               min(start_pair + depth, n_pairs)):
                    futs.append(executor.submit(self._prepare_host, j))
            pending = None  # (i, data, out): optimized, not yet read
            acc = res.stage_s
            for i in range(start_pair, n_pairs):
                with span("gsl.pair", args=i):
                    if prefetch:
                        with span("gsl.wait", acc):
                            host = futs.popleft().result()
                        if i + depth < n_pairs:
                            futs.append(executor.submit(
                                self._prepare_host, i + depth))
                    else:
                        host = self._prepare_host(i)
                    data, scene, (h, w), stages = self._prepare_device(host)
                    clamped = stages.pop("clamped", 0)
                    res.clamped_scales.append(clamped)
                    if clamped:
                        self.logger.log(i, clamped_scales=int(clamped))
                    for k, v in stages.items():
                        acc[k] = acc.get(k, 0.0) + v
                    with span("gsl.optimize", acc):
                        out = optimize_pose(
                            scene, data.tar_c2w, data.src_depth,
                            self.parser.K, w, h, config=self.config,
                            backend=self.backend, device=self.device,
                        )
                    for k, v in dict(out.host_s, launched=out.launched,
                                     segments=out.segments,
                                     replayed=out.replayed).items():
                        acc[k] = acc.get(k, 0) + v
                    with span("gsl.collect", acc):
                        if prefetch:
                            if pending is not None:
                                self._collect_pair(*pending, res, progress,
                                                   t_start, wall_base,
                                                   checkpoint_every)
                            pending = (i, data, out)
                        else:  # strictly serial
                            self._collect_pair(i, data, out, res, progress,
                                               t_start, wall_base,
                                               checkpoint_every)
            if pending is not None:
                with span("gsl.collect", acc):
                    self._collect_pair(*pending, res, progress, t_start,
                                       wall_base, checkpoint_every)
        finally:
            if executor is not None:
                executor.shutdown(wait=True)
        res.wall_s = wall_base + time.time() - t_start
        self.logger.log(
            n_pairs,
            ate_rmse=res.ate_rmse, aae_rmse=res.aae_rmse,
            pose_steps_per_s=res.pose_steps_per_s, wall_s=res.wall_s,
            stage_s={k: round(v, 3) for k, v in res.stage_s.items()},
        )
        self.logger.finish()
        return res
