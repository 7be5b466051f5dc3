"""A run on the fixture suites, pair by pair beside the reference's
records of the same scenes.

`fixture_reference.json` holds the JAX package's per-pair records
(`tools/build_fixture_reference.py` builds it from the run records in
`runs/`; nothing of the reference's speed is kept):

  * "rooms" and "tum": tracking runs with product defaults (`max_steps`
    2000, patience 200, warmup 100, early stop, exact kNN) of the ten
    1200x680 Replica fixture rooms of `data/fixtures.py` and of the two
    TUM fixture scenes of `data/tum_fixture.py` (640x480, crop 8): eT
    (metres), eR (degrees), best loss, steps, rebuilds, selects and the
    scale clamp count of each pair;
  * "icp": the classical baselines on room0's first 40 frames (`cli icp
    --methods ICP PLANE_ICP GICP COLORED_ICP HYBRID --max-pairs 40`), one
    entry "room0_<METHOD>" per method: eT and eR of each pair.

    python -m gsplatloc_tpu_torch.eval.fixture_compare RUN_ROOT [RUN ...]

prints, for each run directory under RUN_ROOT (as `cli track --dataset
ReplicaFixture` or `--dataset TUM`, or `cli icp`, write them with
`--run-dir RUN_ROOT`), the run beside the reference over the pairs the run
holds (the TUM stress scene, whose frames the port's writer does not
reproduce, beside the reference's whole run in its class: clamped
"None"), and writes the comparisons to RUN_ROOT/compare.json.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from ..data.tum_fixture import PER_PAIR
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


def _scene(reference: dict, room: str) -> dict:
    """The reference's tracking record of a Replica room or a TUM scene."""
    for suite in ("rooms", "tum"):
        if room in reference[suite]:
            return reference[suite][room]
    raise KeyError(f"no reference tracking record of {room!r}")


def _ratio(a, b):
    return a / b if b > 0 else float("inf")


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
    ref_room = _scene(reference or load_reference(), room)
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
    return {
        "room": room, "pairs": list(pairs), "port": p, "reference": r,
        "ate_ratio": _ratio(p["ate_rmse"], r["ate_rmse"]),
        "aae_ratio": _ratio(p["aae_rmse"], r["aae_rmse"]),
        "eT_ratio": [_ratio(a, b) for a, b in zip(p["eT"], r["eT"])],
        "clamped_equal": p["clamped_scales"] == r["clamped_scales"],
    }


def compare_class(run, room: str, reference: dict | None = None) -> dict:
    """A run beside the reference's whole run of `room` in its accuracy
    class only: for a scene whose frames the port's writer does not
    reproduce (the TUM stress scene, `data/tum_fixture.py`), the pairs are
    other frames and only the RMSEs compare."""
    ref = _scene(reference or load_reference(), room)
    p, r = _summary(run_pairs(run)), _summary(ref["pairs"])
    return {
        "room": room, "pairs": list(range(len(p["eT"]))), "port": p,
        "reference": r,
        "ate_ratio": _ratio(p["ate_rmse"], r["ate_rmse"]),
        "aae_ratio": _ratio(p["aae_rmse"], r["aae_rmse"]),
        "clamped_equal": None,
    }


def icp_pairs(run) -> dict:
    """{"eT": [...], "eR": [...]} of a baseline run, in pair order. `run`
    is a run directory, its metrics.jsonl, or ICPExperiment.run()'s
    result."""
    if isinstance(run, dict):
        return {"eT": list(run["eT"]), "eR": list(run["eR"])}
    path = Path(run)
    if path.is_dir():
        path = path / "metrics.jsonl"
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    recs = [r for r in recs if "eT" in r]
    if [r["step"] for r in recs] != list(range(1, len(recs) + 1)):
        raise ValueError(f"{path}: pairs are not logged at steps 1..n")
    return {"eT": [r["eT"] for r in recs], "eR": [r["eR"] for r in recs]}


def compare_icp(run, room: str, method: str, pairs: range | None = None,
                reference: dict | None = None) -> dict:
    """A baseline run's pairs `pairs` (default: every pair it holds)
    beside the reference's same pairs of `room` and `method`: ATE-/AAE-RMSE
    (metres, degrees), their ratios and each pair's eT and eR ratio."""
    ref = (reference or load_reference())["icp"][f"{room}_{method}"]
    got = icp_pairs(run)
    pairs = range(len(got["eT"])) if pairs is None else pairs
    if pairs.stop > len(got["eT"]) or pairs.stop > len(ref["pairs"]):
        raise ValueError(f"{room}/{method}: pairs {pairs} beyond the run's "
                         f"{len(got['eT'])} or the reference's "
                         f"{len(ref['pairs'])}")
    p = {k: [got[k][i] for i in pairs] for k in ("eT", "eR")}
    r = {k: [ref["pairs"][i][k] for i in pairs] for k in ("eT", "eR")}
    for d in (p, r):
        d["ate_rmse"], d["aae_rmse"] = rmse(d["eT"]), rmse(d["eR"])
    return {
        "room": room, "method": method, "pairs": list(pairs), "port": p,
        "reference": r,
        "ate_ratio": _ratio(p["ate_rmse"], r["ate_rmse"]),
        "aae_ratio": _ratio(p["aae_rmse"], r["aae_rmse"]),
        "eT_ratio": [_ratio(a, b) for a, b in zip(p["eT"], r["eT"])],
        "eR_ratio": [_ratio(a, b) for a, b in zip(p["eR"], r["eR"])],
    }


def _icp_run(name: str, reference: dict):
    """(room, method) when `name` is a baseline run's directory name
    ("room0_PLANE_ICP"; room names hold no underscore), else None."""
    room, _, method = name.partition("_")
    return (room, method) if name in reference["icp"] else None


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    root, runs = Path(argv[0]), argv[1:]
    runs = runs or sorted(d.name for d in root.iterdir()
                          if (d / "metrics.jsonl").exists())
    reference = load_reference()
    out = {}
    tracking = [r for r in runs if _icp_run(r, reference) is None]
    baselines = [r for r in runs if _icp_run(r, reference) is not None]
    if tracking:
        print("| scene | pairs | port ATE cm | ref ATE cm | ATE ratio | "
              "port AAE deg | ref AAE deg | median steps port / ref | max "
              "eT cm | clamped equal | wall s per pair | decode s | wait s |")
        print("|---|---|---|---|---|---|---|---|---|---|---|---|---|")
    for room in tracking:
        per_pair = room not in reference["tum"] or room in PER_PAIR
        c = (compare if per_pair else compare_class)(
            root / room, room, reference=reference)
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
    if baselines:
        print("| room / method | pairs | port ATE cm | ref ATE cm | ATE ratio "
              "| port AAE deg | ref AAE deg | eT ratio min-max | wall s per "
              "pair |")
        print("|---|---|---|---|---|---|---|---|---|")
    for name in baselines:
        room, method = _icp_run(name, reference)
        c = compare_icp(root / name, room, method, reference=reference)
        recs = [json.loads(line) for line in
                (root / name / "metrics.jsonl").read_text().splitlines()]
        n = len(c["pairs"])
        wall = recs[-1]["ts"] - recs[0]["ts"]  # first pair's log to the end
        out[name] = dict(c, wall_s=wall)
        p, r = c["port"], c["reference"]
        print(f"| {room} / {method} | {n} | {p['ate_rmse'] * 100:.5f} | "
              f"{r['ate_rmse'] * 100:.5f} | {c['ate_ratio']:.4f} | "
              f"{p['aae_rmse']:.5f} | {r['aae_rmse']:.5f} | "
              f"{min(c['eT_ratio']):.4f}-{max(c['eT_ratio']):.4f} | "
              f"{wall / max(n - 1, 1):.2f} |")
    (root / "compare.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
