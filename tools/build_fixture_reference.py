#!/usr/bin/env python3
"""Build gsplatloc_tpu_torch/eval/fixture_reference.json from the JAX
package's run records of the 1200x680 Replica fixture suite.

    python3 tools/build_fixture_reference.py

Reads, for each of the ten fixture rooms, `metrics.jsonl` and
`config.json` of its run under `runs/` (SOURCES) and keeps per pair eT
(metres), eR (degrees), best_loss, steps, rebuilds, selects and
clamped_scales (0 where the run logged no clamp line), plus the run's
ATE-/AAE-RMSE and its tracking config (one config for all rooms; the
script checks they agree). Timestamps and throughput are left out.
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


def main():
    rooms, config = {}, None
    for room, rel in SOURCES.items():
        rec, cfg = room_record(REPO / rel)
        if cfg.pop("scene") != room:
            raise ValueError(f"{rel}: config.json is not {room}'s")
        if config is not None and cfg != config:
            raise ValueError(f"{rel}: config differs from the other rooms'")
        config = cfg
        rooms[room] = rec
    # one line per pair keeps the file readable and its diffs small
    lines = ['{', '"config": ' + json.dumps(config) + ',', '"rooms": {']
    for j, (room, rec) in enumerate(rooms.items()):
        head = {k: v for k, v in rec.items() if k != "pairs"}
        lines.append(json.dumps(room) + ": " + json.dumps(head)[:-1]
                     + ', "pairs": [')
        lines += [json.dumps(p) + ("," if i + 1 < len(rec["pairs"]) else "")
                  for i, p in enumerate(rec["pairs"])]
        lines.append("]}" + ("," if j + 1 < len(rooms) else ""))
    lines += ["}", "}"]
    OUT.write_text("\n".join(lines) + "\n")
    json.loads(OUT.read_text())  # the file parses
    print(f"wrote {OUT.relative_to(REPO)}: {len(rooms)} rooms, "
          f"{sum(len(r['pairs']) for r in rooms.values())} pairs")


if __name__ == "__main__":
    main()
