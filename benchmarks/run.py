"""Benchmark of the PyTorch/CUDA port: frame-pair tracking through
`SequenceRunner.train` on one cell of BENCHMARK.json.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA devices.
Set-up (counted in setup_s): import the port, find the plain reference
of the configuration's tracking path (plainref/paths/<path>.py; without
one the run stops here, before any frame is written or pair tracked),
write the configuration's frames once per checkout (benchmarks/_cache/),
make the cell's clip folders under TMPDIR, track one warm pair. The
window: whole passes over the cell's clips (harness.py), as many as
--seconds asks for. --trace 1 then tracks the cell's traced clip under
torch.profiler (tracer.py) and reports the per-layer metrics. After the
window the seed's sampled pairs are tracked again by the plain reference
(check.py). The last line of standard output is one JSON object:
correct, attempted, failed, metrics, device[, breakdown], checks.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", cell_=None, cfg_=None, bench=None) -> dict:
    """One run; returns the result line's object. cell_/cfg_/bench replace
    the files of that name (the tests run tiny cells on the CPU)."""
    import torch

    import check
    import harness

    bench = bench or harness.spec()
    cell_ = cell_ or harness.cell(workload)
    cfg_ = cfg_ or harness.config(cell_["config"])
    cuda = device.startswith("cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    import gsplatloc_tpu_torch  # noqa: F401  (the system under test)

    # a path with no reference stops here: nothing could judge the run
    harness.reference(harness.tracking_path(cfg_))
    cache = harness.ensure_frames(cell_["config"], cfg_, log)
    order, checked = harness.seed_plan(seed, cell_)
    with tempfile.TemporaryDirectory(prefix="gslbench-") as tmp:
        window = harness.Window(cell_, cfg_, cache, Path(tmp), device)
        # warm-up: the first pair of the first clip, at the cell's shapes
        window.run_clip(order[0], max_pairs=1)
        sync()
        record = harness.Record()
        record.setup_s = time.perf_counter() - T_START
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        runs = window.measure(order, seconds, record, sync)
        record.peak_bytes = (torch.cuda.max_memory_allocated() if cuda
                             else 0)
        log(f"[bench] window {record.window_s:.3f} s, {record.passes} "
            f"pass(es), {record.pairs} pairs")
        breakdown = None
        if trace:
            import tracer

            record.trace, breakdown = tracer.traced_clip(
                window, cell_["traced_clip"], cell_["traced_pairs"], device,
                log)
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        refs = check.reference_pairs(window, checked, device)
        values = check.readings(runs, refs)
        log(f"[bench] reference over {len(refs)} pair(s) in "
            f"{time.perf_counter() - t0:.1f} s")
    checks, ok = check.judge(values, cell_["limits"])
    metrics = harness.read_metrics(bench, trace, record)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(record.peak_bytes)}
    if trace and record.trace is not None:
        dev["busy_s"] = record.trace["busy_s"]
        dev["window_s"] = record.trace["window_s"]
    out = {"correct": bool(ok), "attempted": record.pairs,
           "failed": int(values["missing_pairs"]) + (0 if ok else 1),
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # libraries the port may pull in must not load JAX by themselves
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(HERE.parent))  # the checkout: the port
    import harness

    entry = {w["name"]: w for w in harness.spec()["workloads"]}.get(
        args.workload)
    if entry is None:
        log(f"[bench] no workload {args.workload!r} in BENCHMARK.json")
        return 2
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < entry["chips"]):
        log(f"[bench] {args.workload} needs {entry['chips']} CUDA "
            f"device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    try:
        out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except harness.MissingReference as e:
        log(f"[bench] {args.workload}: {e}; no result")
        return 5
    bad = harness.forbidden_modules()
    if bad:
        log(f"[bench] the run loaded {bad}: no result")
        return 4
    for name, c in out["checks"].items():
        log(f"[check] {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
