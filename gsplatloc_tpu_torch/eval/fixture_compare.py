"""A tracking run on the Replica fixture suite, pair by pair beside the
reference's records of the same rooms.

`fixture_reference.json` holds the JAX package's per-pair records of the
1200x680 fixture suite run with product defaults (`max_steps` 2000,
patience 200, warmup 100, early stop, exact kNN): eT (metres), eR
(degrees), best loss, steps, rebuilds, selects and the scale clamp count
of each pair, for the ten rooms of `data/fixtures.py`
(`tools/build_fixture_reference.py` builds it from the run records in
`runs/`). Nothing of the reference's speed is kept.

    python -m gsplatloc_tpu_torch.eval.fixture_compare RUN_ROOT [ROOM ...]

prints, for each room directory under RUN_ROOT (as `cli track --dataset
ReplicaFixture --run-dir RUN_ROOT` writes them), the run beside the
reference over the pairs the run tracked, and writes the comparisons to
RUN_ROOT/compare.json.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from .metrics import rmse

REFERENCE = Path(__file__).resolve().with_name("fixture_reference.json")

PAIR_FIELDS = ("eT", "eR", "best_loss", "steps", "rebuilds", "selects",
               "clamped_scales")


def load_reference() -> dict:
    return json.loads(REFERENCE.read_text())


def run_pairs(run) -> list[dict]:
    """Per-pair records of a run, in pair order: PAIR_FIELDS and
    slot_overflow. `run` is a run directory, its metrics.jsonl, or a
    SequenceResult."""
    if hasattr(run, "eT"):  # a SequenceResult
        cols = (run.eT, run.eR, run.losses, run.steps, run.rebuilds,
                run.selects, run.clamped_scales, run.slot_overflow)
        if len({len(c) for c in cols}) != 1:
            raise ValueError("the SequenceResult's per-pair lists differ in "
                             "length (a resumed run)")
        return [dict(zip(PAIR_FIELDS + ("slot_overflow",), vals))
                for vals in zip(*cols)]
    path = Path(run)
    if path.is_dir():
        path = path / "metrics.jsonl"
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    pairs = {int(r["step"]): {k: r[k] for k in PAIR_FIELDS if k in r}
             for r in recs if "eT" in r}
    for r in recs:
        i = int(r["step"])
        if i in pairs:
            for k in ("clamped_scales", "slot_overflow"):
                if k in r:
                    pairs[i][k] = r[k]
    if sorted(pairs) != list(range(len(pairs))):
        raise ValueError(f"{path}: pairs {sorted(pairs)} are not 0..n-1")
    return [dict({"clamped_scales": 0, "slot_overflow": 0}, **pairs[i])
            for i in range(len(pairs))]


def _summary(pairs: list[dict]) -> dict:
    out = {k: [p[k] for p in pairs] for k in ("eT", "eR", "best_loss")}
    for k in ("steps", "rebuilds", "selects", "clamped_scales"):
        out[k] = [int(p[k]) for p in pairs]
    for k in ("steps", "rebuilds", "selects"):
        out[f"median_{k}"] = float(np.median(out[k]))
    out["ate_rmse"], out["aae_rmse"] = rmse(out["eT"]), rmse(out["eR"])
    return out


def compare(run, room: str, pairs: range | None = None,
            reference: dict | None = None) -> dict:
    """The run's pairs `pairs` (default: every pair it tracked) beside the
    reference's same pairs of `room`: ATE-/AAE-RMSE (metres, degrees) and
    their ratios, each pair's eT ratio, median steps, rebuilds and
    selects, and the clamp counts, which must be equal (host work in both
    packages)."""
    ref_room = (reference or load_reference())["rooms"][room]
    got = run_pairs(run)
    pairs = range(len(got)) if pairs is None else pairs
    if pairs.stop > len(got) or pairs.stop > len(ref_room["pairs"]):
        raise ValueError(f"{room}: pairs {pairs} beyond the run's "
                         f"{len(got)} or the reference's "
                         f"{len(ref_room['pairs'])}")
    port = [got[i] for i in pairs]
    ref = [ref_room["pairs"][i] for i in pairs]
    p, r = _summary(port), _summary(ref)
    p["slot_overflow"] = [int(x["slot_overflow"]) for x in port]

    def ratio(a, b):
        return a / b if b > 0 else float("inf")

    return {
        "room": room, "pairs": list(pairs), "port": p, "reference": r,
        "ate_ratio": ratio(p["ate_rmse"], r["ate_rmse"]),
        "aae_ratio": ratio(p["aae_rmse"], r["aae_rmse"]),
        "eT_ratio": [ratio(a, b) for a, b in zip(p["eT"], r["eT"])],
        "clamped_equal": p["clamped_scales"] == r["clamped_scales"],
    }


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    root, rooms = Path(argv[0]), argv[1:]
    rooms = rooms or sorted(d.name for d in root.iterdir()
                            if (d / "metrics.jsonl").exists())
    reference = load_reference()
    out = {}
    print("| room | pairs | port ATE cm | ref ATE cm | ATE ratio | port AAE "
          "deg | ref AAE deg | median steps port / ref | max eT cm | "
          "clamped equal | wall s per pair | decode s | wait s |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|---|")
    for room in rooms:
        c = compare(root / room, room, reference=reference)
        recs = [json.loads(line) for line in
                (root / room / "metrics.jsonl").read_text().splitlines()]
        summary = [r for r in recs if "wall_s" in r][-1]
        n = len(c["pairs"])
        c["wall_s"], c["stage_s"] = summary["wall_s"], summary["stage_s"]
        out[room] = c
        p, r = c["port"], c["reference"]
        print(f"| {room} | {n} | {p['ate_rmse'] * 100:.5f} | "
              f"{r['ate_rmse'] * 100:.5f} | {c['ate_ratio']:.3f} | "
              f"{p['aae_rmse']:.5f} | {r['aae_rmse']:.5f} | "
              f"{p['median_steps']:.0f} / {r['median_steps']:.0f} | "
              f"{max(p['eT']) * 100:.5f} | {c['clamped_equal']} | "
              f"{c['wall_s'] / n:.2f} | "
              f"{c['stage_s'].get('decode', 0.0):.1f} | "
              f"{c['stage_s'].get('wait', 0.0):.1f} |")
    (root / "compare.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
