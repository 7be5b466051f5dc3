"""The traced part of a --trace 1 run, after the measured window: the
cell's `traced_clip` tracked for `traced_pairs` + 1 pairs through a new
`SequenceRunner`, with torch.profiler (CPU and CUDA activity) started at
the second pair's device prepare. So the trace holds `traced_pairs`
steady pairs: not the runner's construction, nor the first pair, whose
host prepare nothing hides.

Spans: the benchmark's own `record_function` ranges around the calls into
each layer of the port, put in place for the traced clip only by wrapping
the module attributes the port looks up at call time. A name the port no
longer has stops the run (instrument raises), so that no span or
roofline goes missing unseen:

    bench.steady         the traced stretch: from the second pair's device
                         prepare to the end of the clip
    bench.host_prepare   SequenceRunner._prepare_host (decode + kNN, worker)
    bench.device_prepare SequenceRunner._prepare_device (pair, target, scene)
    bench.optimize       optimize_pose, as the runner calls it
    bench.rebuild        ops.kcover.build_kcover_slot_buffer
    bench.select         ops.kcover.build_kcover_buffer (K3)
    bench.step_render    ops.kcover.render_tracking_depth_kcover (K1)
    bench.loss           opt.tracking.tracking_loss
    bench.adam           opt.tracking.adam_step
    bench.collect        SequenceRunner._collect_pair

Launch inputs for the rooflines: the cover buffer and camera of K1/K2
launches and the slot buffer and camera of K3 launches in the stretch,
held for the launches of a few selections (the 1st, 2nd, 4th, 8th, ... of
the stretch, so that the held buffers stay a few); their bounds
(bounds.py) are set against the device time of the same launches, matched
to the trace's kernels by launch order.

Readings (the record's `trace`): busy_s (the union of kernel, copy and
set intervals), window_s (the bench.steady span), and per kernel group the
bound and device milliseconds. The breakdown: the ten device operations
with the most time, and the idle time grouped by the innermost span the
main thread was in when each gap began.
"""

from __future__ import annotations

import functools
import importlib
import json
import tempfile
import time
from pathlib import Path

SPANS = [
    ("gsplatloc_tpu_torch.tracking.runner", "SequenceRunner._prepare_host",
     "bench.host_prepare"),
    ("gsplatloc_tpu_torch.tracking.runner", "SequenceRunner._prepare_device",
     "bench.device_prepare"),
    ("gsplatloc_tpu_torch.tracking.runner", "optimize_pose", "bench.optimize"),
    ("gsplatloc_tpu_torch.tracking.runner", "SequenceRunner._collect_pair",
     "bench.collect"),
    ("gsplatloc_tpu_torch.ops.kcover", "build_kcover_slot_buffer",
     "bench.rebuild"),
    ("gsplatloc_tpu_torch.ops.kcover", "build_kcover_buffer", "bench.select"),
    ("gsplatloc_tpu_torch.ops.kcover", "render_tracking_depth_kcover",
     "bench.step_render"),
    ("gsplatloc_tpu_torch.opt.tracking", "tracking_loss", "bench.loss"),
    ("gsplatloc_tpu_torch.opt.tracking", "adam_step", "bench.adam"),
]
# kernel-name fragments of the launches the rooflines read
K1, K2, K2_SUM, K3 = ("kcover_step_fwd_kernel", "kcover_step_bwd_kernel",
                      "sum12_kernel", "kcover_select_kernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _patch(target, attr, wrap) -> tuple:
    old = getattr(target, attr, None)
    if old is None:
        raise AttributeError(
            f"{getattr(target, '__name__', target)} has no {attr}: the "
            f"benchmark's span or launch hook there cannot be attached")
    setattr(target, attr, wrap(old))
    return (target, attr, old)


def _spanned(name, fn):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def inner(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return inner


class Launches:
    """The inputs of K1/K2 and K3 launches, held for a few selections."""

    def __init__(self):
        self.on = False  # recording: the traced stretch has begun
        self.steps = []  # (kbuf or None, cam): one per K1 launch
        self.selects = []  # (args or None): one per K3 launch
        self._kbufs = 0

    def _keep(self) -> bool:
        n = self._kbufs
        return n > 0 and (n & (n - 1)) == 0  # 1, 2, 4, 8, ...

    def step_fwd(self, fn):
        @functools.wraps(fn)
        def inner(kbuf, cam, *a, **k):
            if self.on:
                self.steps.append((kbuf if self._keep() else None, cam))
            return fn(kbuf, cam, *a, **k)
        return inner

    def select(self, fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            if self.on:
                self._kbufs += 1
                self.selects.append(a if self._keep() else None)
            return fn(*a, **k)
        return inner


def instrument(launches: Launches) -> list:
    """Wrap the port's layer entry points in spans and the launch
    recorders; returns what `restore` puts back. Raises where the port
    lacks one of them."""
    undo = []
    try:
        for mod_name, attr, span in SPANS:
            target = importlib.import_module(mod_name)
            if "." in attr:
                cls, attr = attr.split(".")
                target = _attr(target, cls)
            undo.append(_patch(target, attr,
                               lambda fn, s=span: _spanned(s, fn)))
        kc = importlib.import_module("gsplatloc_tpu_torch.ops.kcover")
        undo.append(_patch(kc, "kcover_step_fwd", launches.step_fwd))
        undo.append(_patch(kc, "select_kcover_records", launches.select))
    except AttributeError:
        restore(undo)
        raise
    return undo


def _attr(mod, name: str):
    if not hasattr(mod, name):
        raise AttributeError(f"{mod.__name__} has no {name}: the "
                             f"benchmark's spans there cannot be attached")
    return getattr(mod, name)


def restore(undo: list) -> None:
    """Put the port's functions back, with the launch counters the
    wrappers carried (functools.wraps copied them over)."""
    for target, attr, old in reversed(undo):
        new = getattr(target, attr)
        if hasattr(new, "launches"):
            old.launches = new.launches
        setattr(target, attr, old)


def _union(intervals: list) -> tuple:
    """(total length, merged [start, end] list) of intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _durations(kernels: list, fragment: str) -> list:
    return [k[3] for k in kernels if fragment in k[1]]


def _roofline_inputs(launches: Launches, kernels: list, window) -> dict:
    """{group: {"bound_ms", "device_ms", "launches"}} over the held
    launches, each matched to its kernel by launch order."""
    import torch

    from bounds import select_bound, step_bounds

    w, h = window.image_wh
    n_tx, n_ty = -(-w // 128), -(-h // 16)
    near, far = window.tracking.near_plane, window.tracking.far_plane
    out = {}
    d1, d2, ds = (_durations(kernels, K1), _durations(kernels, K2),
                  _durations(kernels, K2_SUM))
    if len(d1) == len(launches.steps) == len(d2) == len(ds):
        b = t = 0.0
        n = 0
        for i, (kb, cam) in enumerate(launches.steps):
            if kb is None:
                continue
            with torch.no_grad():
                b1, b2 = step_bounds(kb, cam, n_ty, n_tx, near, far)
            b += b1 + b2
            t += (d1[i] + d2[i] + ds[i]) / 1e3
            n += 1
        if n:
            out["kstep"] = {"bound_ms": b, "device_ms": t, "launches": n}
    d3 = _durations(kernels, K3)
    if d3 and len(d3) == len(launches.selects):
        b = t = 0.0
        n = 0
        for i, args in enumerate(launches.selects):
            if args is None:
                continue
            with torch.no_grad():
                b += select_bound(*args[:8])
            t += d3[i] / 1e3
            n += 1
        if n:
            out["kselect"] = {"bound_ms": b, "device_ms": t, "launches": n}
    return out


def _events(prof) -> list:
    """(category, name, start_us, duration_us, thread) of every event of
    the profile, in the chrome trace's categories (user_annotation,
    cpu_op, kernel, gpu_memcpy, gpu_memset, ...): from the kineto results
    where their events carry the category, else from the exported
    chrome trace (under TMPDIR)."""
    events = prof.profiler.kineto_results.events()
    if events and hasattr(events[0], "activity_type"):
        return [(e.activity_type(), e.name(), e.start_ns() / 1e3,
                 e.duration_ns() / 1e3, e.start_thread_id())
                for e in events]
    with tempfile.TemporaryDirectory(prefix="gslbench-trace-") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())["traceEvents"]
    return [(e.get("cat"), e.get("name"), e["ts"], e["dur"], e.get("tid"))
            for e in trace if e.get("ph") == "X" and "dur" in e]


def traced_clip(window, clip: int, pairs: int, device: str, log) -> tuple:
    """Track `pairs` + 1 pairs of `clip`, the last `pairs` under the
    profiler; returns (the record's trace readings, the result line's
    breakdown)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from gsplatloc_tpu_torch.tracking.runner import SequenceRunner

    cuda = device.startswith("cuda")
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    steady = record_function("bench.steady")
    launches = Launches()
    calls = []

    def open_stretch(fn):
        """The second device prepare starts the profiler and the span."""
        @functools.wraps(fn)
        def inner(*a, **k):
            calls.append(1)
            if len(calls) == 2:
                if cuda:
                    torch.cuda.synchronize()
                prof.start()
                steady.__enter__()
                launches.on = True
            return fn(*a, **k)
        return inner

    undo = instrument(launches)
    t0 = time.perf_counter()
    try:
        undo.append(_patch(SequenceRunner, "_prepare_device", open_stretch))
        window.run_clip(clip, max_pairs=pairs + 1)
        if len(calls) < 2:
            raise RuntimeError(f"clip {clip} has no second pair to trace")
        if cuda:
            torch.cuda.synchronize()
        steady.__exit__(None, None, None)
        t1 = time.perf_counter()
        prof.stop()
    finally:
        restore(undo)
    t2 = time.perf_counter()
    events = _events(prof)
    del prof
    t3 = time.perf_counter()
    readings, breakdown = summarize(events)
    kernels = sorted((e for e in events if e[0] == "kernel"),
                     key=lambda e: e[2])
    del events
    t4 = time.perf_counter()
    readings.update(_roofline_inputs(launches, kernels, window))
    t5 = time.perf_counter()
    log(f"[bench] traced clip {t1 - t0:.1f} s ({pairs} of {pairs + 1} "
        f"pairs traced), profiler stop {t2 - t1:.1f}"
        f" s, events {t3 - t2:.1f} s, timeline {t4 - t3:.1f} s, bounds "
        f"{t5 - t4:.1f} s")
    return readings, breakdown


def summarize(events: list) -> tuple:
    """(busy_s, window_s) and the breakdown from (category, name, start,
    duration, thread) events, times in microseconds."""
    stretch = [e for e in events if e[1] == "bench.steady"
               and e[0] == "user_annotation"]
    if not stretch:
        raise RuntimeError("the trace holds no bench.steady span")
    _cat, _name, c0, dur, main_tid = stretch[0]
    c1 = c0 + dur
    dev = [e for e in events if e[0] in DEVICE_CATS]
    busy, merged = _union([(max(e[2], c0), min(e[2] + e[3], c1))
                           for e in dev if e[2] < c1 and e[2] + e[3] > c0])
    by_name = {}
    for e in dev:
        by_name[e[1]] = by_name.get(e[1], 0.0) + e[3]
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # idle gaps on the card, each labelled by the innermost span of the
    # main thread open when it began: one sweep over gaps and spans, both
    # in time order, with the open spans on a stack (they nest)
    spans = sorted(((e[2], e[2] + e[3], e[1]) for e in events
                    if e[0] == "user_annotation" and e[4] == main_tid
                    and e[1].startswith("bench.")),
                   key=lambda s: (s[0], -s[1]))
    gaps, prev = [], c0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if c1 > prev:
        gaps.append((prev, c1))
    idle, stack, k = {}, [], 0
    for g0, g1 in gaps:
        while k < len(spans) and spans[k][0] <= g0:
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        label = stack[-1][2] if stack else "(no span)"
        idle[label] = idle.get(label, 0.0) + (g1 - g0)
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    readings = {"busy_s": busy / 1e6, "window_s": (c1 - c0) / 1e6}
    breakdown = {
        "device_ops": [[n, d / 1e6] for n, d in device_ops],
        "idle_gaps": [[n, d / 1e6] for n, d in idle_gaps],
    }
    return readings, breakdown
