"""The readings the check's limits are set from, for one cell, in one
process on the card:

    python3 benchmarks/calibrate.py --workload <cell>

Every pair of the cell's pass (a run checks pairs drawn from these) is
tracked three ways: by the port (each clip through
`SequenceRunner.train`, as in the window), by the plain reference, and by
the control, the plain reference with TF32 matmuls and convolutions (the
configurations state float32 with TF32 off; TF32 is the step below). The
port's poses and the control's are each read against the reference's,
pair by pair, by check.readings and judged by check.judge under the
cell's limits, as a run's are: the port's readings are the lower ones,
the control's the upper. One JSON line per pair, then a summary: the
largest reading of the port, the smallest of the control, and the pairs
on which the port fails or the control passes.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
NAMES = ("pose_gap_cm", "rot_gap_deg")


def calibrate(cell: dict, cfg: dict, cache: Path, tmp: Path, device: str,
              emit=print) -> dict:
    """Per-pair readings of the port and of the control under the cell's
    limits; returns the summary."""
    import check
    import harness

    harness.reference(harness.tracking_path(cfg))  # before any pair
    window = harness.Window(cell, cfg, cache, tmp, device)
    rows = []
    for clip in range(len(cell["clips"])):
        run = window.run_clip(clip)
        keys = [(clip, j) for j in range(len(run.frames) - 1)]
        ref, ctl, secs = {}, {}, {}
        for key in keys:
            t0 = time.perf_counter()
            ref.update(check.reference_pairs(window, [key], device))
            ctl.update(check.reference_pairs(window, [key], device,
                                             tf32=True))
            secs[key] = time.perf_counter() - t0
            if device.startswith("cuda"):
                import torch

                torch.cuda.empty_cache()
        control = harness.ClipRun(clip, run.frames, SimpleNamespace(
            poses_est=[ctl[k]["best_c2w"] for k in keys]))
        for key in keys:
            port, port_ok = check.judge(
                check.readings([run], {key: ref[key]}), cell["limits"])
            tf32, tf32_ok = check.judge(
                check.readings([control], {key: ref[key]}), cell["limits"])
            row = {"pair": list(key),
                   "port": {k: port[k]["value"] for k in NAMES},
                   "port_correct": port_ok,
                   "tf32": {k: tf32[k]["value"] for k in NAMES},
                   "tf32_correct": tf32_ok,
                   "steps": [int(run.result.steps[key[1]]),
                             ref[key]["steps"], ctl[key]["steps"]],
                   "selects": [int(run.result.selects[key[1]]),
                               ref[key]["selects"], ctl[key]["selects"]],
                   "reference_s": round(secs[key], 1)}
            rows.append(row)
            emit(json.dumps(row))
    summary = {
        "lower": {k: max(r["port"][k] for r in rows) for k in NAMES},
        "upper": {k: min(r["tf32"][k] for r in rows) for k in NAMES},
        "limits": cell["limits"],
        "port_fails": [r["pair"] for r in rows if not r["port_correct"]],
        "tf32_passes": [r["pair"] for r in rows if r["tf32_correct"]],
    }
    emit(json.dumps({"summary": summary}))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(HERE.parent))
    import harness

    c = harness.cell(args.workload)
    cfg = harness.config(c["config"])
    try:
        harness.reference(harness.tracking_path(cfg))  # before any frame
    except harness.MissingReference as e:
        print(f"{args.workload}: {e}", file=sys.stderr)
        return 5
    cache = harness.ensure_frames(c["config"], cfg)
    with tempfile.TemporaryDirectory(prefix="gslbench-cal-") as tmp:
        calibrate(c, cfg, cache, Path(tmp), "cuda",
                  emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
