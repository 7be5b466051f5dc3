"""The K-cover tracking loop on the card, held against another checkout's.

    python3 tools/graph_check.py [--tree DIR] [--cell room0-stream]
        [--clip 0] [--pairs 4] [--sync-check] --out FILE
    python3 tools/graph_check.py --compare A.json B.json

Tracks `--pairs` pairs of one clip of a benchmark cell (the benchmark's
own frames, written once under benchmarks/_cache/) through
`SequenceRunner.train`, twice in one process, with the port of the
checkout DIR (default: this one). Writes one JSON object: the card's name
and power limit; per pass, per pair, the estimated pose (its float32 bytes
in hex and as numbers), the best loss, the steps run, selects and rebuilds;
per pass the launched steps, the steps served by graph replays (where the
port counts them) and the wall seconds; the peak allocated bytes of each
phase of the second pass (device prepare, rebuild, select, the rest),
each read between synchronisations. With --sync-check (a checkout with the
staged K-cover step) the second pass runs every segment's launched steps
under torch.cuda.set_sync_debug_mode("error"): a step that waits for the
card raises.

--compare reads two such files and exits non-zero unless their passes
agree bit for bit in every pose, loss and count.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COUNTS = ("steps", "selects", "rebuilds")


def card() -> dict:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return {"nvidia_smi": out}


class PhasePeaks:
    """Peak allocated bytes by phase: each phase change synchronises, reads
    the peak since the last change into the phase that ends, and resets."""

    def __init__(self):
        import torch

        self.torch = torch
        self.peaks = {}
        self.phase = "rest"
        self.on = True

    def switch(self, phase: str) -> None:
        t = self.torch
        if self.on:
            t.cuda.synchronize()
            p = t.cuda.max_memory_allocated()
            self.peaks[self.phase] = max(self.peaks.get(self.phase, 0), p)
            t.cuda.reset_peak_memory_stats()
        self.phase = phase

    def wrap(self, phase: str, fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            prev = self.phase
            self.switch(phase)
            try:
                return fn(*a, **k)
            finally:
                self.switch(prev)
        return inner


def run(args) -> dict:
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(ROOT / "benchmarks"))
    sys.path.insert(0, str(tree))
    import torch

    import harness
    from gsplatloc_tpu_torch.ops import kcover
    from gsplatloc_tpu_torch.opt import tracking
    from gsplatloc_tpu_torch.tracking.runner import SequenceRunner

    assert Path(tracking.__file__).resolve().is_relative_to(tree), (
        tracking.__file__, tree)
    cell = harness.cell(args.cell)
    cfg = harness.config(cell["config"])
    cache = harness.ensure_frames(cell["config"], cfg,
                                  lambda m: print(m, file=sys.stderr))
    peaks = PhasePeaks()
    undo = []
    for target, attr, phase in (
            (SequenceRunner, "_prepare_device", "device_prepare"),
            (kcover, "build_kcover_slot_buffer", "rebuild"),
            (kcover, "build_kcover_buffer", "select")):
        undo.append((target, attr, getattr(target, attr)))
        setattr(target, attr, peaks.wrap(phase, getattr(target, attr)))
    staged = getattr(tracking, "_KcoverSteps", None)
    out = {"tree": str(tree), "cell": args.cell, "clip": args.clip,
           "device": torch.cuda.get_device_name(0), **card(), "passes": []}
    with tempfile.TemporaryDirectory(prefix="graphcheck-") as tmp:
        window = harness.Window(cell, cfg, cache, Path(tmp), "cuda")
        for p in range(2):
            peaks.on = p == 1
            if p == 1:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                if args.sync_check:
                    real = staged.segment

                    def segment(self, *a, **k):
                        torch.cuda.set_sync_debug_mode("error")
                        try:
                            return real(self, *a, **k)
                        finally:
                            torch.cuda.set_sync_debug_mode("default")

                    undo.append((staged, "segment", real))
                    staged.segment = segment
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = window.run_clip(args.clip, max_pairs=args.pairs).result
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peaks.switch("rest")
            pairs = []
            for i, c2w in enumerate(res.poses_est):
                arr = torch.as_tensor(c2w).to(torch.float32).numpy()
                pairs.append({
                    "pose_hex": arr.tobytes().hex(),
                    "pose": arr.tolist(),
                    "loss": float(res.losses[i]),
                    **{k: int(getattr(res, k)[i]) for k in COUNTS}})
            out["passes"].append({
                "pairs": pairs, "wall_s": wall,
                "launched": int(res.stage_s.get("launched", 0)),
                "replayed": res.stage_s.get("replayed"),
                "segments": int(res.stage_s.get("segments", 0)),
                "optimize_s": res.stage_s.get("optimize")})
    for target, attr, old in reversed(undo):
        setattr(target, attr, old)
    out["peak_bytes"] = peaks.peaks
    if args.sync_check:
        out["sync_checked_segments"] = out["passes"][1]["segments"]
    return out


def compare(a_path: str, b_path: str) -> int:
    a = json.loads(Path(a_path).read_text())
    b = json.loads(Path(b_path).read_text())
    bad = []
    for p, (pa, pb) in enumerate(zip(a["passes"], b["passes"])):
        if pa["launched"] != pb["launched"]:
            bad.append(f"pass {p}: launched {pa['launched']} vs "
                       f"{pb['launched']}")
        if len(pa["pairs"]) != len(pb["pairs"]):
            bad.append(f"pass {p}: {len(pa['pairs'])} vs {len(pb['pairs'])}"
                       " pairs")
        for i, (x, y) in enumerate(zip(pa["pairs"], pb["pairs"])):
            for k in ("pose_hex", "loss", *COUNTS):
                if x[k] != y[k]:
                    bad.append(f"pass {p} pair {i}: {k} differs")
    print(json.dumps({"equal": not bad, "differences": bad[:20]}))
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--cell", default="room0-stream")
    ap.add_argument("--clip", type=int, default=0)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--sync-check", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    out = run(args)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    summary = {k: v for k, v in out.items() if k != "passes"}
    summary["passes"] = [{k: v for k, v in p.items() if k != "pairs"}
                         for p in out["passes"]]
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
