"""Command-line entry points of the PyTorch/CUDA port.

Usage:
  python -m gsplatloc_tpu_torch.cli track --dataset Synthetic --frames 40
  python -m gsplatloc_tpu_torch.cli track --dataset Synthetic --kcover 0
  python -m gsplatloc_tpu_torch.cli track --dataset Replica --rooms room0 \
      --data-root datasets/Replica --num-iters 2000 --run-dir runs/track
  python -m gsplatloc_tpu_torch.cli tables --res runs/track/res.json \
      --dataset Synthetic

`track` runs on the CUDA device unless `--device cpu` is given (the plain
PyTorch versions of the kernels; slow beyond small images) and writes one
run directory per room plus `res.json` under --run-dir.
"""

from __future__ import annotations

import argparse
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
    from .eval.logger import write_res_json
    from .eval.metrics import set_random_seed
    from .opt.tracking import TrackingConfig
    from .tracking.runner import SequenceRunner

    if args.host_shard:
        raise NotImplementedError(
            "--host-shard needs parallel/distributed.py, which is not "
            "ported yet (ROADMAP item 17)")
    set_random_seed(args.seed)

    cfg = TrackingConfig(max_steps=args.num_iters, patience=200,
                         warmup_steps=100, kcover=args.kcover,
                         coast_after_steps=args.coast_after_steps,
                         select_motion_px=args.select_gate,
                         resort_motion_px=args.resort_gate)
    all_rooms = (Replica.ROOMS if args.dataset == "Replica"
                 else TUM.SCENES if args.dataset == "TUM" else [""])
    rooms = _room_list(args, all_rooms)
    results = {args.dataset: {}}
    run_root = Path(args.run_dir)
    for room in rooms:
        kwargs = {}
        if args.dataset == "Synthetic":
            kwargs = dict(n_frames=args.frames, height=args.height,
                          width=args.width, seed=args.seed)
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
        print(f"{args.dataset}/{room}: ATE-RMSE {res.ate_rmse*100:.5f} cm  "
              f"AAE-RMSE {res.aae_rmse:.5f} deg  "
              f"({res.pose_steps_per_s:.0f} pose-steps/s)")
    write_res_json(results, run_root / "res.json")
    print(f"wrote {run_root/'res.json'}")


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
    raise NotImplementedError(
        "icp: the classical baselines (tracking/icp.py, tracking/odometry.py) "
        "are not ported yet (ROADMAP item 15)")


def cmd_render(args):
    raise NotImplementedError(
        "render: the general rasterizer is not ported yet (ROADMAP item 13)")


def build_parser():
    ap = argparse.ArgumentParser(prog="gsplatloc_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("track", help="gsplat pose-tracking eval")
    t.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the tracking runs (cpu: the plain PyTorch "
                        "versions of the kernels)")
    t.add_argument("--dataset", default="Synthetic",
                   choices=["Replica", "TUM", "Synthetic"])
    t.add_argument("--rooms", nargs="*", default=None)
    t.add_argument("--all", action="store_true")
    t.add_argument("--room-range", nargs=2, type=int, default=None,
                   metavar=("START", "END"))
    t.add_argument("--office-range", nargs=2, type=int, default=None,
                   metavar=("START", "END"))
    t.add_argument("--seed", type=int, default=42)
    t.add_argument("--num-iters", type=int, default=2000)
    t.add_argument("--max-pairs", type=int, default=1998)
    # "fused" (the frozen-scene tracking kernels) is the only ported backend
    t.add_argument("--backend", default="fused")
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
                   help="RGBD comparison panel every N pairs (not ported: "
                        "> 0 raises)")
    t.add_argument("--pcd-every", type=int, default=0,
                   help="3D point-cloud inspection PNG every N pairs (not "
                        "ported: > 0 raises)")
    t.add_argument("--no-prefetch", action="store_true",
                   help="strictly serial loop, no host prefetch worker")
    t.add_argument("--run-dir", default="runs/track")
    t.add_argument("--data-root", default=None,
                   help="dataset root override (e.g. a generated "
                        "Replica-format fixture)")
    t.add_argument("--frames", type=int, default=40)
    t.add_argument("--height", type=int, default=680)
    t.add_argument("--width", type=int, default=1200)
    t.add_argument("--quiet", action="store_true")
    t.add_argument("--host-shard", action="store_true",
                   help="multi-host room sharding (not ported: raises)")
    t.set_defaults(fn=cmd_track)

    tb = sub.add_parser("tables", help="res.json -> markdown tables")
    tb.add_argument("--res", default=None)
    tb.add_argument("--runs", default=None,
                    help="aggregate all */metrics.jsonl under this runs/ "
                         "tree into res.json first")
    tb.add_argument("--dataset", default="Replica")
    tb.set_defaults(fn=cmd_tables)

    # the reference's other two subcommands: not ported yet, they raise
    # (whatever flags they are given)
    for name, fn, what in (("icp", cmd_icp, "classical ICP baseline sweep"),
                           ("render", cmd_render,
                            "novel-view fly-through renders")):
        sub.add_parser(name, help=f"{what} (not ported yet)").set_defaults(
            fn=fn)
    return ap


def main(argv=None):
    ap = build_parser()
    args, extra = ap.parse_known_args(argv)
    if extra and args.fn not in (cmd_icp, cmd_render):
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    args.fn(args)


if __name__ == "__main__":
    main()
