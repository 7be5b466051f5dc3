#!/usr/bin/env python3
"""Build gsplatloc_tpu_torch/eval/fixture_reference.json from the JAX
package's run records of the fixture suites.

    python3 tools/build_fixture_reference.py

Reads, for each of the ten Replica fixture rooms (1200x680) and the two
TUM fixture scenes (640x480, crop 8), `metrics.jsonl` and `config.json` of
its tracking run under `runs/` (SOURCES, TUM_SOURCES) and keeps per pair
eT (metres), eR (degrees), best_loss, steps, rebuilds, selects and
clamped_scales (0 where the run logged no clamp line), plus the run's
ATE-/AAE-RMSE and its tracking config (one config for all rooms, and one
for both TUM scenes that differs from it only in the dataset; the script
checks they agree). For the classical baselines on room0 (`cli icp`, 40
frames; ICP_SOURCES) it keeps each method's per-pair eT and eR, its
ATE-/AAE-RMSE and its config. Timestamps and throughput are left out.
"""

from __future__ import annotations

import json
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "gsplatloc_tpu_torch" / "eval" / "fixture_reference.json"

_SUITE = "runs/tpu_session_r5b/suite"
SOURCES = {
    **{room: f"{_SUITE}/replica/{room}" for room in (
        "room0", "room1", "room2", "office0", "office1", "office2",
        "office3", "office4")},
    "dense0": f"{_SUITE}/replica_dense0/dense0",
    "dense1": "runs/tpu_session_r5e/dense1/dense1",
}
TUM_SOURCES = {
    "freiburg1_desk": f"{_SUITE}/tum_desk/freiburg1_desk",
    "freiburg2_stress": f"{_SUITE}/tum_stress/freiburg2_stress",
}
ICP_METHODS = ("ICP", "PLANE_ICP", "GICP", "COLORED_ICP", "HYBRID")
ICP_SOURCES = {("room0", m): f"runs/tpu_session_r3b/icp_fixture/room0_{m}"
               for m in ICP_METHODS}
PAIR_FIELDS = ("eT", "eR", "best_loss", "steps", "rebuilds", "selects")
COUNTS = ("steps", "rebuilds", "selects", "clamped_scales")


def room_record(run_dir: Path) -> tuple[dict, dict]:
    recs = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    pairs = {r["step"]: {k: r[k] for k in PAIR_FIELDS}
             for r in recs if "eT" in r}
    n = len(pairs)
    if sorted(pairs) != list(range(n)):
        raise ValueError(f"{run_dir}: pairs are not 0..{n - 1}")
    for p in pairs.values():
        p["clamped_scales"] = 0
    for r in recs:
        if "clamped_scales" in r and r["step"] in pairs:
            pairs[r["step"]]["clamped_scales"] = r["clamped_scales"]
    out = [dict(pairs[i]) for i in range(n)]
    for p in out:
        for k in COUNTS:
            if p[k] != int(p[k]):
                raise ValueError(f"{run_dir}: {k} {p[k]} is not a count")
            p[k] = int(p[k])
    summary = [r for r in recs if "ate_rmse" in r][-1]
    cfg = json.loads((run_dir / "config.json").read_text())
    return ({"source": str(run_dir.relative_to(REPO)), "frames": n + 1,
             "ate_rmse": summary["ate_rmse"],
             "aae_rmse": summary["aae_rmse"], "pairs": out}, cfg)


def suite_records(sources: dict, dataset: str) -> tuple[dict, dict]:
    """Each scene's record and the suite's one tracking config."""
    out, config = {}, None
    for scene, rel in sources.items():
        rec, cfg = room_record(REPO / rel)
        if cfg.pop("scene") != scene:
            raise ValueError(f"{rel}: config.json is not {scene}'s")
        if cfg["dataset"] != dataset:
            raise ValueError(f"{rel}: dataset {cfg['dataset']}, not {dataset}")
        if config is not None and cfg != config:
            raise ValueError(f"{rel}: config differs from the other scenes'")
        config = cfg
        out[scene] = rec
    return out, config


def icp_record(run_dir: Path) -> dict:
    """One baseline run: per pair (frame i against frame i-1, logged at
    step i) eT and eR, the ATE-/AAE-RMSE and the run's config."""
    recs = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    pairs = [{"eT": r["eT"], "eR": r["eR"]} for r in recs if "eT" in r]
    steps = [r["step"] for r in recs if "eT" in r]
    if steps != list(range(1, len(pairs) + 1)):
        raise ValueError(f"{run_dir}: pairs are not logged at steps 1..n")
    summary = [r for r in recs if "ate_rmse" in r][-1]
    return {"source": str(run_dir.relative_to(REPO)),
            "frames": len(pairs) + 1, "ate_rmse": summary["ate_rmse"],
            "aae_rmse": summary["aae_rmse"],
            "config": json.loads((run_dir / "config.json").read_text()),
            "pairs": pairs}


def _scene_lines(scenes: dict, last: bool) -> list:
    """One line per pair keeps the file readable and its diffs small."""
    lines = []
    for j, (name, rec) in enumerate(scenes.items()):
        head = {k: v for k, v in rec.items() if k != "pairs"}
        lines.append(json.dumps(name) + ": " + json.dumps(head)[:-1]
                     + ', "pairs": [')
        lines += [json.dumps(p) + ("," if i + 1 < len(rec["pairs"]) else "")
                  for i, p in enumerate(rec["pairs"])]
        lines.append("]}" + ("," if j + 1 < len(scenes) else ""))
    lines.append("}" + ("" if last else ","))
    return lines


def main():
    rooms, config = suite_records(SOURCES, "Replica")
    tum, tum_config = suite_records(TUM_SOURCES, "TUM")
    if dict(tum_config, dataset="Replica") != config:
        raise ValueError("the TUM runs' config differs from the rooms' in "
                         "more than the dataset")
    icp = {}
    for (room, method), rel in ICP_SOURCES.items():
        rec = icp_record(REPO / rel)
        if rec["config"]["algorithm"] != method:
            raise ValueError(f"{rel}: config.json is not {method}'s")
        icp[f"{room}_{method}"] = rec
    lines = ['{', '"config": ' + json.dumps(config) + ',', '"rooms": {']
    lines += _scene_lines(rooms, last=False)
    lines += ['"tum_config": ' + json.dumps(tum_config) + ',', '"tum": {']
    lines += _scene_lines(tum, last=False)
    lines += ['"icp": {']
    lines += _scene_lines(icp, last=True)
    lines += ["}"]
    OUT.write_text("\n".join(lines) + "\n")
    json.loads(OUT.read_text())  # the file parses
    print(f"wrote {OUT}: {len(rooms)} rooms, "
          f"{sum(len(r['pairs']) for r in rooms.values())} pairs; "
          f"{len(tum)} TUM scenes, "
          f"{sum(len(r['pairs']) for r in tum.values())} pairs; "
          f"{len(icp)} baseline runs, "
          f"{sum(len(r['pairs']) for r in icp.values())} pairs")


if __name__ == "__main__":
    main()
