"""Command-line entry points of the PyTorch/CUDA port.

Usage:
  python -m gsplatloc_tpu_torch.cli track --dataset Synthetic --frames 40
  python -m gsplatloc_tpu_torch.cli track --dataset Synthetic --kcover 0
  python -m gsplatloc_tpu_torch.cli track --dataset Synthetic --backend pallas
  python -m gsplatloc_tpu_torch.cli track --dataset Replica --rooms room0 \
      --data-root datasets/Replica --num-iters 2000 --run-dir runs/track
  python -m gsplatloc_tpu_torch.cli track --dataset ReplicaFixture \
      --rooms room0 dense0 --frames 80 --run-dir runs/fixture
  python -m gsplatloc_tpu_torch.cli track --dataset TUM \
      --data-root datasets/TUM_fixture --rooms freiburg1_desk
  python -m gsplatloc_tpu_torch.cli icp --dataset ReplicaFixture \
      --rooms room0 --methods ICP PLANE_ICP GICP COLORED_ICP HYBRID \
      --max-pairs 40
  python -m gsplatloc_tpu_torch.cli tables --res runs/track/res.json \
      --dataset Synthetic
  python -m gsplatloc_tpu_torch.cli render --dataset Synthetic \
      --width 1200 --height 680 --n-views 24 --out runs/render

`track` runs on the CUDA device unless `--device cpu` is given (the plain
PyTorch versions of the kernels; slow beyond small images) and writes one
run directory per room plus `res.json` under --run-dir; with `--profile
DIR` (and a few `--max-pairs`) it runs under torch.profiler, writes
DIR/trace.json and prints the card's busy share and its idle seconds by
the innermost `gsl.*` span open when each gap began. `icp` runs the
classical baselines (tracking/icp.py): the registrations on the host, the
back-projection and HYBRID's dense odometry on the device; one run
directory per room and method plus the resume ledger `finished.jsonl`.
`render` builds a frozen scene from one frame and writes one
[RGB | depth colormap] PNG panel per view of a camera path, rendered by
the general rasterizer (on the card unless `--device cpu`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
from pathlib import Path


def _room_list(args, all_rooms):
    if getattr(args, "all", False):
        return all_rooms
    rooms = list(args.rooms or [])
    # inclusive index ranges over Replica's room*/office* scenes
    rr = getattr(args, "room_range", None)
    if rr:
        rooms += [f"room{i}" for i in range(rr[0], rr[1] + 1)]
    orng = getattr(args, "office_range", None)
    if orng:
        rooms += [f"office{i}" for i in range(orng[0], orng[1] + 1)]
    return rooms or all_rooms[:1]


def cmd_track(args):
    from .data.datasets import TUM, Replica
    from .data.fixtures import ReplicaFixture
    from .eval.logger import write_res_json
    from .eval.metrics import set_random_seed
    from .opt.tracking import TrackingConfig
    from .tracking.runner import SequenceRunner
    from .utils.profiling import TRACE_FILE, profile_trace

    set_random_seed(args.seed)

    cfg = TrackingConfig(max_steps=args.num_iters, patience=200,
                         warmup_steps=100, kcover=args.kcover,
                         coast_after_steps=args.coast_after_steps,
                         select_motion_px=args.select_gate,
                         resort_motion_px=args.resort_gate)
    all_rooms = {"Replica": Replica.ROOMS, "TUM": TUM.SCENES,
                 "ReplicaFixture": ReplicaFixture.ROOMS}.get(args.dataset,
                                                             [""])
    rooms = _room_list(args, all_rooms)
    if args.host_shard:
        # several processes: each takes its room subset (scene-level data
        # parallelism; parallel/distributed.py). No-op in one process.
        from .parallel import shard_scenes

        rooms = shard_scenes(rooms)
    results = {args.dataset: {}}
    run_root = Path(args.run_dir)
    with (profile_trace(args.profile, device=args.device) if args.profile
          else contextlib.nullcontext()):
        for room in rooms:
            kwargs = {}
            if args.dataset == "Synthetic":
                kwargs = dict(n_frames=args.frames, height=args.height,
                              width=args.width, seed=args.seed)
            elif args.dataset == "ReplicaFixture":
                kwargs = dict(frames=args.frames, height=args.height,
                              width=args.width)
            elif args.data_root:
                kwargs = dict(root=args.data_root)
            runner = SequenceRunner(
                data_set=args.dataset, scene_name=room, normalize=True,
                config=cfg, backend=args.backend,
                run_dir=run_root / (room or "synthetic"),
                max_pairs=args.max_pairs, algorithm=args.algorithm,
                panel_every=args.panel_every, pcd_every=args.pcd_every,
                knn_method=args.knn, device=args.device,
                **kwargs,
            )
            res = runner.train(progress=not args.quiet,
                               prefetch=not args.no_prefetch)
            results[args.dataset][room or "synthetic"] = {
                args.algorithm: {"eT": res.eT, "eR": res.eR}
            }
            print(f"{args.dataset}/{room}: "
                  f"ATE-RMSE {res.ate_rmse*100:.5f} cm  "
                  f"AAE-RMSE {res.aae_rmse:.5f} deg  "
                  f"({res.pose_steps_per_s:.0f} pose-steps/s)")
    write_res_json(results, run_root / "res.json")
    print(f"wrote {run_root/'res.json'}")
    if args.profile:
        print_idle_table(Path(args.profile) / TRACE_FILE)


def print_idle_table(trace_path):
    """The trace's device busy share over its `gsl.pair` spans and the idle
    seconds by the innermost `gsl.*` span of the main thread open when
    each gap began (no busy share where the trace holds no device work)."""
    from .utils.profiling import idle_by_span, trace_events

    events = trace_events(trace_path)
    busy, window, idle = idle_by_span(events)
    head = f"{trace_path}: {window:.3f} s of gsl.pair spans"
    if busy > 0:
        head += f", device busy {busy:.3f} s ({100.0 * busy / window:.2f} %)"
    print(head)
    print(f"{'idle by span':<16} {'s':>10} {'% of idle':>10}")
    total = sum(idle.values()) or 1.0
    for name, sec in sorted(idle.items(), key=lambda kv: -kv[1]):
        print(f"{name:<16} {sec:>10.4f} {100.0 * sec / total:>10.2f}")


def cmd_tables(args):
    from .eval.logger import (
        aggregate_runs, results_markdown_table, write_res_json,
    )

    if not args.runs and not args.res:
        raise SystemExit("tables: provide --res or --runs")
    if args.runs:
        # reduce every run under a tree to one res.json
        results = aggregate_runs(args.runs)
        res = write_res_json(results, Path(args.runs) / "res.json")
        print(f"aggregated {sum(len(r) for d in results.values() for r in d.values())} "
              f"runs -> {Path(args.runs)/'res.json'}\n")
    else:
        res = json.loads(Path(args.res).read_text())
    print(f"## {args.dataset} — ATE RMSE [cm]\n")
    print(results_markdown_table(res, args.dataset, "ate_rmse", 100.0))
    print(f"\n## {args.dataset} — AAE RMSE [deg]\n")
    print(results_markdown_table(res, args.dataset, "aae_rmse", 1.0))
    # per-scene throughput, when every run carried the runner's summary row
    if all("steps_per_s" in a for r in res.get(args.dataset, {}).values()
           for a in r.values()):
        print(f"\n## {args.dataset} — pose-opt steps/s (e2e wall)\n")
        print(results_markdown_table(res, args.dataset, "steps_per_s", 1.0))


def cmd_icp(args):
    from .data.datasets import TUM, Replica, SyntheticBoxRoom
    from .data.fixtures import ReplicaFixture
    from .tracking.icp import run_icp_sweep

    if args.dataset == "Replica":
        rooms = _room_list(args, Replica.ROOMS)

        def factory(scene):
            return Replica(scene, root=args.data_root or "datasets/Replica")
    elif args.dataset == "TUM":
        rooms = _room_list(args, TUM.SCENES)

        def factory(scene):
            return TUM(scene, root=args.data_root or "datasets/TUM")
    elif args.dataset == "ReplicaFixture":
        rooms = _room_list(args, ReplicaFixture.ROOMS)

        def factory(scene):
            # the fixture suite's rooms: 80 frames at 1200x680 unless asked
            return ReplicaFixture(scene, frames=args.frames or 80,
                                  height=args.height or 680,
                                  width=args.width or 1200)
    else:
        rooms = ["synthetic"]

        def factory(scene):
            return SyntheticBoxRoom(n_frames=args.frames or 40,
                                    height=args.height or 240,
                                    width=args.width or 320)

    res = run_icp_sweep(
        factory, rooms, methods=args.methods, run_root=args.run_dir,
        max_images=args.max_pairs, device=args.device,
    )
    for (scene, method), out in res.items():
        print(f"{scene}/{method}: ATE-RMSE {out['ate_rmse']*100:.5f} cm  "
              f"AAE-RMSE {out['aae_rmse']:.5f} deg")


def flythrough_path(args):
    """The frame a fly-through's scene is built from and its camera path:
    the dataset's poses in a window of up to 16 frames from --frame (moved
    back when --frame is near the end: the path generators need two poses;
    a one-frame dataset gets a second pose 5 cm off), through the --path
    generator. Returns (frame, path (n_views, 4, 4) float64)."""
    import numpy as np

    from .data import traj
    from .data.datasets import get_dataset

    kwargs = {}
    if args.dataset == "Synthetic":
        kwargs = dict(n_frames=max(args.frame + 8, 12), height=args.height,
                      width=args.width)
    elif args.data_root:
        kwargs = dict(root=args.data_root)
    ds = get_dataset(args.dataset, args.scene, **kwargs)
    frame = ds[args.frame]
    ctx_end = min(len(ds), args.frame + 16)
    ctx_start = args.frame if ctx_end - args.frame >= 2 else max(
        0, ctx_end - 2)
    poses = np.stack([np.asarray(ds[i].c2w)
                      for i in range(ctx_start, ctx_end)])
    if poses.shape[0] < 2:
        p2 = poses[0].copy()
        p2[:3, 3] += 0.05
        poses = np.stack([poses[0], p2])
    if args.path == "ellipse_z":
        path = traj.generate_ellipse_path_z(poses, n_frames=args.n_views)
    elif args.path == "ellipse_y":
        path = traj.generate_ellipse_path_y(poses, n_frames=args.n_views)
    else:
        # keeps the keyframes' orientation: looking at the next path point
        # is degenerate for near-static (tracking-style) trajectories
        path = traj.generate_interpolated_path(
            poses, max(args.n_views // max(len(poses) - 1, 1), 1),
            look_at_neighbor=False,
        )
    return frame, path


def frame_scene(frame, device):
    """The frozen scene of one RGB-D frame on `device`: its depth
    back-projected and placed in the world, grid-window kNN scales.
    Returns (scene, K)."""
    from ._device import as_f32
    from .models.gaussians import scene_from_point_cloud
    from .ops.camera import depth_to_points
    from .ops.lie import transform_points

    h, w = frame.hw
    K = as_f32(frame.K, device)
    pts_cam = depth_to_points(as_f32(frame.depth, device), K)
    pts = transform_points(as_f32(frame.c2w, device), pts_cam)
    rgbs = as_f32(frame.rgb.reshape(-1, 3), device) / 255.0
    scene = scene_from_point_cloud(pts, rgbs, grid_shape=(h, w),
                                   device=device)
    return scene, K


def render_view(scene, K, c2w, width, height, backend="pallas"):
    """RGB+ED render of the scene at a camera-to-world pose (a (3, 4) or
    (4, 4) array), SH degree 1. Returns (render (H, W, 4), alpha (H, W))."""
    import numpy as np
    import torch

    from ._device import as_f32
    from .ops.lie import invert_se3
    from .ops.rasterize import rasterize

    c2w4 = np.eye(4, dtype=np.float32)
    c2w4[: c2w.shape[0]] = c2w
    with torch.no_grad():
        return rasterize(
            scene.means, scene.quats, scene.scales, scene.opacities,
            scene.sh_coeffs, invert_se3(as_f32(c2w4, K.device)), K, width,
            height, sh_degree=1, render_mode="RGB+ED", backend=backend,
        )


def render_panel(render):
    """(H, W, 4) RGB+ED render (numpy) -> the (H, 2W, 3) uint8 RGB panel
    [clipped RGB | depth colormap]."""
    import numpy as np

    from .eval.visualize import depth_to_colormap

    rgb = np.clip(render[..., :3], 0, 1)
    return np.concatenate(
        [(rgb * 255).astype(np.uint8), depth_to_colormap(render[..., 3])],
        axis=1)


def cmd_render(args):
    """Novel-view fly-through: a frozen scene built from one RGB-D frame,
    rendered RGB+ED along a camera path through the dataset's poses, one
    [RGB | depth colormap] PNG panel per view. Timers (utils/profiling):
    render/data (frames and path), render/scene, render/view (the render on
    the device), render/panel (read back, colormap, PNG encode)."""
    from ._device import resolve_device
    from .data.png import imwrite
    from .utils.profiling import time_block

    dev = resolve_device(args.device)
    with time_block("render/data"):
        frame, path = flythrough_path(args)
    with time_block("render/scene") as tb:
        scene, K = tb.watch(frame_scene(frame, dev))
    h, w = frame.hw
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, c2w in enumerate(path):
        with time_block("render/view") as tb:
            render, _alpha = tb.watch(
                render_view(scene, K, c2w, w, h, args.backend))
        with time_block("render/panel"):
            panel = render_panel(render.cpu().numpy())
            imwrite(out_dir / f"view_{i:04d}.png", panel[..., ::-1])  # BGR
    print(f"wrote {len(path)} views to {out_dir}")


def build_parser():
    ap = argparse.ArgumentParser(prog="gsplatloc_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("track", help="gsplat pose-tracking eval")
    t.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the tracking runs (cpu: the plain PyTorch "
                        "versions of the kernels)")
    t.add_argument("--dataset", default="Synthetic",
                   choices=["Replica", "TUM", "Synthetic", "ReplicaFixture"],
                   help="ReplicaFixture: the generated Replica-format "
                        "fixture rooms (data/fixtures.py), rendered in "
                        "memory, no files")
    t.add_argument("--rooms", nargs="*", default=None)
    t.add_argument("--all", action="store_true")
    t.add_argument("--room-range", nargs=2, type=int, default=None,
                   metavar=("START", "END"))
    t.add_argument("--office-range", nargs=2, type=int, default=None,
                   metavar=("START", "END"))
    t.add_argument("--seed", type=int, default=42)
    t.add_argument("--num-iters", type=int, default=2000)
    t.add_argument("--max-pairs", type=int, default=1998)
    t.add_argument("--backend", default="fused",
                   choices=["fused", "pallas", "reference"],
                   help="fused: the frozen-scene tracking kernels (K-cover "
                        "or sub-tile, --kcover); pallas: the general "
                        "rasterizer's tiled kernels; reference: its dense "
                        "oracle (small images only)")
    t.add_argument("--algorithm", default="gsplatloc_tpu")
    t.add_argument("--kcover", type=int, default=16,
                   help="per-pixel K-cover rendering with K covers "
                        "(ops/kcover.py); 0 = the sub-tile render "
                        "(ops/fused_subtile.py). 16 is the product default")
    t.add_argument("--select-gate", type=float, default=2.0,
                   help="K-cover selection staleness gate in px of bounded "
                        "screen motion (select_motion_px)")
    t.add_argument("--resort-gate", type=float, default=4.0,
                   help="binning-rebuild staleness gate in px of bounded "
                        "screen motion (resort_motion_px)")
    t.add_argument("--coast-after-steps", type=int, default=30,
                   help="loosen the staleness gates 8x after this many "
                        "non-improving steps (0 = coast off)")
    t.add_argument("--knn", default="auto",
                   choices=["auto", "grid", "exact", "brute"],
                   help="scale-init kNN: auto = exact over the host C++ "
                        "KdTree (raises if it cannot be built), grid = the "
                        "pixel-window approximation on the device")
    t.add_argument("--panel-every", type=int, default=0,
                   help="write an RGBD comparison panel every N pairs "
                        "(0 = off; needs matplotlib)")
    t.add_argument("--pcd-every", type=int, default=0,
                   help="write a 3D point-cloud inspection PNG (pair "
                        "cloud + camera frusta) every N pairs (0 = off; "
                        "needs matplotlib)")
    t.add_argument("--no-prefetch", action="store_true",
                   help="strictly serial loop, no host prefetch worker")
    t.add_argument("--run-dir", default="runs/track")
    t.add_argument("--data-root", default=None,
                   help="dataset root override (e.g. a generated "
                        "Replica-format fixture)")
    t.add_argument("--frames", type=int, default=40,
                   help="sequence length of the generated datasets "
                        "(Synthetic, ReplicaFixture; the reference's "
                        "fixture suite has 80 frames a room)")
    t.add_argument("--height", type=int, default=680)
    t.add_argument("--width", type=int, default=1200)
    t.add_argument("--quiet", action="store_true")
    t.add_argument("--host-shard", action="store_true",
                   help="several processes: this process tracks "
                        "rooms[i::P] of the process group set up by "
                        "parallel.initialize(); one process: all rooms")
    t.add_argument("--profile", default=None, metavar="DIR",
                   help="run under torch.profiler, write DIR/trace.json "
                        "and print the device's idle time by gsl.* span "
                        "(give a few --max-pairs)")
    t.set_defaults(fn=cmd_track)

    tb = sub.add_parser("tables", help="res.json -> markdown tables")
    tb.add_argument("--res", default=None)
    tb.add_argument("--runs", default=None,
                    help="aggregate all */metrics.jsonl under this runs/ "
                         "tree into res.json first")
    tb.add_argument("--dataset", default="Replica")
    tb.set_defaults(fn=cmd_tables)

    i = sub.add_parser("icp", help="classical ICP baseline sweep")
    i.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the clouds are back-projected and HYBRID's "
                        "dense odometry runs (the registrations run on the "
                        "host)")
    i.add_argument("--dataset", default="Synthetic",
                   choices=["Replica", "TUM", "Synthetic", "ReplicaFixture"],
                   help="ReplicaFixture: the generated Replica-format "
                        "fixture rooms (data/fixtures.py), rendered in "
                        "memory, no files")
    i.add_argument("--rooms", nargs="*", default=None)
    i.add_argument("--all", action="store_true")
    i.add_argument("--methods", nargs="*",
                   default=["ICP", "PLANE_ICP", "GICP"],
                   help="ICP, PLANE_ICP, GICP, COLORED_ICP, HYBRID")
    i.add_argument("--max-pairs", type=int, default=2000,
                   help="frames read per sequence (the reference's name)")
    i.add_argument("--run-dir", default="runs/icp_sweep")
    i.add_argument("--data-root", default=None)
    i.add_argument("--frames", type=int, default=None,
                   help="sequence length of the generated datasets "
                        "(Synthetic 40, ReplicaFixture 80)")
    i.add_argument("--height", type=int, default=None,
                   help="Synthetic 240, ReplicaFixture 680")
    i.add_argument("--width", type=int, default=None,
                   help="Synthetic 320, ReplicaFixture 1200")
    i.set_defaults(fn=cmd_icp)

    r = sub.add_parser("render", help="novel-view fly-through renders")
    r.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the scene is built and rendered (cpu: the "
                        "plain PyTorch versions of the kernels)")
    r.add_argument("--dataset", default="Synthetic",
                   choices=["Replica", "TUM", "Synthetic"])
    r.add_argument("--scene", default="")
    r.add_argument("--data-root", default=None)
    r.add_argument("--frame", type=int, default=0,
                   help="dataset frame the scene is built from")
    r.add_argument("--path", default="spline",
                   choices=["ellipse_z", "ellipse_y", "spline"],
                   help="spline keeps keyframe orientations (works for any "
                        "trajectory); the ellipse orbits re-aim at the "
                        "focus point and are degenerate for near-static "
                        "(tracking-style) sequences")
    r.add_argument("--n-views", type=int, default=24)
    r.add_argument("--backend", default="pallas",
                   choices=["pallas", "reference"],
                   help="pallas: the general rasterizer's tiled kernels; "
                        "reference: its dense oracle (small images only)")
    r.add_argument("--height", type=int, default=240)
    r.add_argument("--width", type=int, default=320)
    r.add_argument("--out", default="runs/render")
    r.set_defaults(fn=cmd_render)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
