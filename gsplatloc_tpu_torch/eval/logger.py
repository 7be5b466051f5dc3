"""Experiment logging + results aggregation.

Local JSONL metric streams, the res.json results format
({dataset: {room: {algorithm: {"ate_rmse", "aae_rmse"}}}}) and markdown
tables from it. Host-side Python and numpy only.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

from .metrics import rmse


class ExperimentLogger:
    """Scalar/series logger. One JSONL file per run + in-memory series."""

    def __init__(self, run_dir: str | Path, config: dict | None = None):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.series = defaultdict(list)
        self._fh = open(self.run_dir / "metrics.jsonl", "a")
        if config:
            with open(self.run_dir / "config.json", "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, step: int, **metrics):
        rec = {"step": int(step), "ts": time.time()}
        for k, v in metrics.items():
            if isinstance(v, dict):  # structured extras (e.g. stage_s):
                rec[k] = v  # JSONL only — not a scalar series
                continue
            v = float(v)
            rec[k] = v
            self.series[k].append((int(step), v))
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def finish(self):
        self._fh.close()

    def values(self, key: str):
        return [v for _, v in self.series[key]]


def write_res_json(
    results: dict, path: str | Path = "res.json"
) -> dict:
    """Aggregate per-pair eT/eR series into the res.json format:
    {dataset: {room: {algorithm: {"ate_rmse": m, "aae_rmse": deg}}}}
    (ATE stored in meters — tables multiply by 100 for cm).
    """
    out = {}
    for dataset, rooms in results.items():
        out[dataset] = {}
        for room, algos in rooms.items():
            out[dataset][room] = {}
            for algo, series in algos.items():
                out[dataset][room][algo] = {
                    "ate_rmse": rmse(series["eT"]),
                    "aae_rmse": rmse(series["eR"]),
                }
                if series.get("steps_per_s") is not None:
                    # per-scene throughput of the run
                    out[dataset][room][algo]["steps_per_s"] = float(
                        series["steps_per_s"])
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    return out


def aggregate_runs(runs_root: str | Path,
                   algorithm: str = "gsplatloc_tpu") -> dict:
    """Scan a runs/ tree for per-run metric streams and reduce them to the
    res.json structure: per-pair eT/eR to ATE/AAE RMSE per
    (dataset, room, algorithm), over local `*/metrics.jsonl` files.

    Each run directory must hold `metrics.jsonl` (ExperimentLogger stream
    with per-pair eT/eR records) and optionally `config.json` providing
    `dataset`, `scene` and `algorithm`. Runs of different rooms land as
    sibling room directories and merge naturally; when the SAME
    (dataset, room, algorithm) appears in several run dirs, the most
    recently modified stream wins and every shadowed stream is reported
    on stderr (path + record count) so aggregated tables stay auditable.
    """
    import sys

    runs_root = Path(runs_root)
    picked = {}  # (dataset, room, algo) -> (mtime, eT list, eR list, path)
    for mfile in sorted(runs_root.rglob("metrics.jsonl")):
        cfg_path = mfile.parent / "config.json"
        cfg = {}
        if cfg_path.exists():
            try:
                cfg = json.loads(cfg_path.read_text())
            except json.JSONDecodeError:
                pass
        dataset = cfg.get("dataset", "unknown")
        room = cfg.get("scene") or mfile.parent.name
        algo = cfg.get("algorithm", algorithm)
        eT, eR = [], []
        steps_per_s = None
        with open(mfile) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail line from an interrupted run
                if "eT" in rec and "eR" in rec:
                    eT.append(rec["eT"])
                    eR.append(rec["eR"])
                if "pose_steps_per_s" in rec:  # runner's final summary row
                    steps_per_s = rec["pose_steps_per_s"]
        if not eT:
            continue
        key = (dataset, room, algo)
        mtime = mfile.stat().st_mtime
        if key not in picked:
            picked[key] = (mtime, eT, eR, mfile, steps_per_s)
        else:
            kept, dropped = picked[key], (mtime, eT, eR, mfile, steps_per_s)
            if mtime > kept[0]:
                picked[key], dropped = dropped, kept
            print(
                f"[aggregate_runs] duplicate {key}: keeping newer "
                f"{picked[key][3]} ({len(picked[key][1])} pairs), "
                f"dropping {dropped[3]} ({len(dropped[1])} pairs)",
                file=sys.stderr,
            )
    results = {}
    for (dataset, room, algo), (_, eT, eR, _p, sps) in picked.items():
        results.setdefault(dataset, {}).setdefault(room, {})[algo] = {
            "eT": eT, "eR": eR, "steps_per_s": sps,
        }
    return results


def results_markdown_table(res: dict, dataset: str, metric: str = "ate_rmse",
                           scale: float = 100.0) -> str:
    """res.json -> markdown table (ATE x100 converts meters to cm)."""
    rooms = sorted(res[dataset].keys())
    algos = sorted({a for r in rooms for a in res[dataset][r]})
    lines = ["| Method | Avg. | " + " | ".join(rooms) + " |",
             "|---" * (len(rooms) + 2) + "|"]
    for algo in algos:
        # one cell per room header: a '-' placeholder for missing rooms
        # (a compacted list would shift values under the wrong scene)
        vals = [res[dataset][r][algo][metric] * scale
                if algo in res[dataset][r] else None for r in rooms]
        present = [v for v in vals if v is not None]
        avg = float(np.mean(present)) if present else float("nan")
        row = [f"{algo}", f"{avg:.5f}"] + [
            "-" if v is None else f"{v:.5f}" for v in vals]
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)
