"""The traced part of a --trace 1 run, after the measured window: the
cell's `traced_clip` tracked for `traced_pairs` + 1 pairs through a new
`SequenceRunner`, with torch.profiler (CPU and CUDA activity) started at
the second pair's device prepare. So the trace holds `traced_pairs`
steady pairs: not the runner's construction, nor the first pair, whose
host prepare nothing hides.

Spans: the port's own `gsl.*` ranges (its `utils/profiling.py:span`,
recorded while a profiler runs), and the benchmark's `record_function`
ranges around the runner's calls into each layer, put in place for the
traced clip only by wrapping the module attributes the port looks up at
call time. A name the port no longer has stops the run (instrument
raises), so that no span or roofline goes missing unseen:

    bench.steady         the traced stretch: from the second pair's device
                         prepare to the end of the clip
    bench.host_prepare   SequenceRunner._prepare_host (decode + kNN, worker)
    bench.device_prepare SequenceRunner._prepare_device (pair, target, scene)
    bench.optimize       optimize_pose, as the runner calls it
    bench.collect        SequenceRunner._collect_pair

Rooflines: one group of kernels a file, rooflines/<group>.py, found by
name; each names

    HOOKS    the port's (module, attribute) whose calls carry the inputs
             of one launch of the group
    KERNELS  the kernel-name fragments whose device time one call makes
    CLOCK    optional: the group whose calls count this group's sampling
             clock (kstep follows kselect's selections); by default the
             group's own calls
    hold     hold(*args, **kwargs) -> what the bound needs of a call
    bound    bound(held, window) -> the launch's least time, ms

The hooks of every group are attached. Each group counts its own calls
only, and holds a call's inputs while its clock's count is 1, 2, 4, 8,
... (so that the held buffers stay a few); a group added later cannot
move another's samples. The bounds (bounds.py) are set against the
device time of the same launches, matched to the trace's kernels by
launch order. A group whose kernel counts do not match its calls, or
whose hooks saw no call, reads nothing.

Readings (the record's `trace`): busy_s (the union of kernel, copy and
set intervals), window_s (the bench.steady span), and per group the bound
and device milliseconds. The breakdown: the ten device operations with the
most time, and the idle time grouped by the innermost `gsl.*` span the
main thread was in when each gap began (the innermost `bench.*` span
outside them).
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
]
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def groups() -> dict:
    """{group: module} of every rooflines/<group>.py, by name."""
    import harness

    return {p.stem: harness.load(p, f"bench_roofline_{p.stem}")
            for p in sorted((harness.HERE / "rooflines").glob("*.py"))}


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
    """The inputs of the roofline groups' launches, each group's held for
    a few ticks of its clock."""

    def __init__(self, groups_: dict):
        self.on = False  # recording: the traced stretch has begun
        self.groups = groups_
        # per group, one entry a call: its held inputs, or None
        self.held = {name: [] for name in groups_}
        self.calls = {name: 0 for name in groups_}  # per group, its own
        self.clock = {}
        for name, group in groups_.items():
            self.clock[name] = getattr(group, "CLOCK", name)
            if self.clock[name] not in groups_:
                raise KeyError(f"roofline group {name}'s CLOCK "
                               f"{self.clock[name]!r} is no group")

    def _keep(self, name: str) -> bool:
        n = self.calls[self.clock[name]]
        return n > 0 and (n & (n - 1)) == 0  # 1, 2, 4, 8, ...

    def hook(self, name: str, fn):
        group = self.groups[name]

        @functools.wraps(fn)
        def inner(*a, **k):
            if self.on:
                self.calls[name] += 1
                self.held[name].append(
                    group.hold(*a, **k) if self._keep(name) else None)
            return fn(*a, **k)
        return inner


def _target(mod_name: str, attr: str) -> tuple:
    """(object, attribute name) of "module", "attr" or "Class.attr"."""
    target = importlib.import_module(mod_name)
    if "." in attr:
        cls, attr = attr.split(".")
        if not hasattr(target, cls):
            raise AttributeError(
                f"{mod_name} has no {cls}: the benchmark's spans there "
                f"cannot be attached")
        target = getattr(target, cls)
    return target, attr


def instrument(launches: Launches) -> list:
    """Wrap the runner's layer entry points in spans and every roofline
    group's hooks in the launch recorder; returns what `restore` puts
    back. Raises where the port lacks one of them."""
    undo = []
    try:
        for mod_name, attr, span in SPANS:
            undo.append(_patch(*_target(mod_name, attr),
                               lambda fn, s=span: _spanned(s, fn)))
        for name, group in launches.groups.items():
            for mod_name, attr in group.HOOKS:
                undo.append(_patch(*_target(mod_name, attr),
                                   lambda fn, g=name: launches.hook(g, fn)))
    except AttributeError:
        restore(undo)
        raise
    return undo


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
    """{group: {"bound_ms", "device_ms", "launches"}} over each group's
    held launches, each matched to its kernels by launch order."""
    import torch

    out = {}
    for name, group in launches.groups.items():
        held = launches.held[name]
        durations = [_durations(kernels, f) for f in group.KERNELS]
        if not held or any(len(d) != len(held) for d in durations):
            continue
        b = t = 0.0
        n = 0
        for i, inputs in enumerate(held):
            if inputs is None:
                continue
            with torch.no_grad():
                b += group.bound(inputs, window)
            t += sum(d[i] for d in durations) / 1e3
            n += 1
        if n:
            out[name] = {"bound_ms": b, "device_ms": t, "launches": n}
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
    launches = Launches(groups())
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
    # idle gaps on the card, each labelled by the innermost `gsl.*` span
    # of the main thread open when it began (the innermost `bench.*` one
    # outside them): one sweep over gaps and spans, both in time order,
    # with the open spans on a stack (a thread's spans nest)
    spans = sorted(((e[2], e[2] + e[3], e[1]) for e in events
                    if e[0] == "user_annotation" and e[4] == main_tid
                    and e[1].startswith(("gsl.", "bench."))),
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
            while stack and stack[-1][1] <= spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        label = _label(stack, g0)
        idle[label] = idle.get(label, 0.0) + (g1 - g0)
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    readings = {"busy_s": busy / 1e6, "window_s": (c1 - c0) / 1e6}
    breakdown = {
        "device_ops": [[n, d / 1e6] for n, d in device_ops],
        "idle_gaps": [[n, d / 1e6] for n, d in idle_gaps],
    }
    return readings, breakdown


def _label(stack: list, t: float) -> str:
    """The innermost `gsl.*` span of the open (start, end, name) spans
    `stack` at time t, else the innermost `bench.*` one."""
    for prefix in ("gsl.", "bench."):
        for _s, e, name in reversed(stack):
            if e > t and name.startswith(prefix):
                return name
    return "(no span)"
