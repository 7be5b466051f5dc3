"""Host cost of the tracking loop's spans with no profiler recording.

    python3 tools/span_cost.py [--segments N] [--repeats R]

Times the spans `optimize_pose` opens (utils/profiling.py:span) on empty
blocks, in the loop's own nesting: per segment of `resort_every` launched
steps one `gsl.segment` holding, per step, `gsl.step` around `gsl.render`,
`gsl.loss`, `gsl.backward` and `gsl.adam`, and one `gsl.read`; all but
`gsl.segment` add into a dict, as in the loop. The same loop with no spans
is subtracted. For scale, an unconditional `record_function` enter and
exit is timed too. Prints one JSON line: the median over the repeats of
the spans' microseconds per launched step, the record_function
microseconds per range, the host (and the card's name and power limit
where `nvidia-smi` answers).
"""

from __future__ import annotations

import argparse
import json
import platform
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from torch.autograd.profiler import record_function  # noqa: E402

from gsplatloc_tpu_torch.opt.tracking import TrackingConfig  # noqa: E402
from gsplatloc_tpu_torch.utils.profiling import span  # noqa: E402

STEP_PARTS = ("gsl.render", "gsl.loss", "gsl.backward", "gsl.adam")


def spans_loop(segments: int, seg_len: int) -> float:
    into = {}
    t0 = time.perf_counter()
    for _ in range(segments):
        with span("gsl.segment"):
            for _ in range(seg_len):
                with span("gsl.step", into):
                    for name in STEP_PARTS:
                        with span(name, into):
                            pass
            with span("gsl.read", into):
                pass
    return time.perf_counter() - t0


def bare_loop(segments: int, seg_len: int) -> float:
    t0 = time.perf_counter()
    for _ in range(segments):
        for _ in range(seg_len):
            for _name in STEP_PARTS:
                pass
    return time.perf_counter() - t0


def record_function_us(n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        with record_function("gsl.step"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def card() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--segments", type=int, default=2000)
    ap.add_argument("--repeats", type=int, default=15)
    args = ap.parse_args(argv)
    seg_len = TrackingConfig().resort_every
    launched = args.segments * seg_len
    spans_loop(100, seg_len)  # warm-up
    bare_loop(100, seg_len)
    per_step = [
        (spans_loop(args.segments, seg_len) - bare_loop(args.segments,
                                                        seg_len))
        / launched * 1e6 for _ in range(args.repeats)]
    rf = [record_function_us(20000) for _ in range(args.repeats)]
    print(json.dumps({
        "spans_us_per_launched_step": statistics.median(per_step),
        "spans_us_per_launched_step_min_max": [min(per_step),
                                               max(per_step)],
        "spans_per_launched_step": 1 + len(STEP_PARTS) + 2 / seg_len,
        "record_function_us": statistics.median(rf),
        "host": platform.processor() or platform.machine(),
        "card": card(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
