"""Profiling hooks: torch.profiler traces, spans, wall-clock timers.

`profile_trace(log_dir)` records the block with torch.profiler (host
operations of every thread, and the card's kernels when the device is a
card) and writes it as a Chrome trace, `<log_dir>/trace.json`
(chrome://tracing, Perfetto). `span(name, into)` marks a block of the
port's own code: a `record_function` range while a profiler records, and
the block's host seconds added into a dict whether or not one does.
`trace_events` reads a written trace back and `idle_by_span` splits the
card's idle time by the innermost span open when each gap began.
`time_block(name)` adds the block's wall clock to a registry of named
timers (`timer_stats`).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.autograd.profiler import record_function

from .._device import DEFAULT_DEVICE, resolve_device

_TIMERS: dict[str, list[float]] = defaultdict(list)
TRACE_FILE = "trace.json"
# chrome-trace categories of work on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profile_trace(log_dir: str | Path = "runs/trace", device=DEFAULT_DEVICE):
    """Trace the block; yields the torch.profiler profile (its
    `key_averages()` sums by operation). Every thread's host operations
    are recorded, the runner's prefetch worker's spans too. The card's
    work is waited for before the trace closes."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True))) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(str(out / TRACE_FILE))


class span:
    """`with span("gsl.<key>", into, args):` marks a block of the port.

    While a torch profiler records (in any thread: the check is the
    process-wide flag torch sets at the profiler's start, since
    `_profiler_enabled()` is per thread and reads False under
    `profile_all_threads`), the block is a `record_function(name, args)`
    range, a kineto event on the clock of the card's kernels; otherwise no
    range is opened (an unconditional one costs ~1.5 small torch ops).
    Given a dict `into`, the block's host seconds (`time.perf_counter`)
    are added to `into[key]` whether or not a profiler records. `args`:
    the pair index, so that the spans of one pair share an identifier (the
    range's string input: RecordFunction observers see it, torch's Chrome
    export drops it). A span launches no device work and waits for
    nothing."""

    __slots__ = ("name", "key", "into", "args", "_range", "_t0")

    def __init__(self, name: str, into: dict | None = None, args=None):
        self.name = name
        self.key = name.removeprefix("gsl.")
        self.into = into
        self.args = args
        self._range = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._range = record_function(
                self.name, None if self.args is None else str(self.args))
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.into is not None:
            self.into[self.key] = (self.into.get(self.key, 0.0)
                                   + time.perf_counter() - self._t0)
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


def trace_events(path: str | Path) -> list:
    """(category, name, start_us, duration_us, thread) of every complete
    event of a Chrome trace written by `profile_trace`."""
    trace = json.loads(Path(path).read_text())["traceEvents"]
    return [(e.get("cat"), e.get("name"), e["ts"], e["dur"], e.get("tid"))
            for e in trace if e.get("ph") == "X" and "dur" in e]


def idle_by_span(events: list, prefix: str = "gsl.",
                 outer: str = "pair") -> tuple:
    """(busy_s, window_s, {span name: idle_s}) of (category, name,
    start_us, duration_us, thread) events. The window runs from the first
    `prefix + outer` span to the end of the last; its thread is the main
    thread. busy: the union of the card's kernels, copies and sets in the
    window. Each gap between them is labelled by the innermost `prefix`
    span of the main thread open when it began ("(no span)" outside
    every one)."""
    top = [e for e in events
           if e[0] == "user_annotation" and e[1] == prefix + outer]
    if not top:
        raise ValueError(f"the trace holds no {prefix + outer} span")
    main = top[0][4]
    c0 = min(e[2] for e in top)
    c1 = max(e[2] + e[3] for e in top)
    busy, gaps, prev = 0.0, [], c0
    for s, e in sorted((max(e[2], c0), min(e[2] + e[3], c1)) for e in events
                       if e[0] in DEVICE_CATS
                       and e[2] < c1 and e[2] + e[3] > c0):
        if s > prev:
            gaps.append((prev, s))
        if e > prev:
            busy += e - max(s, prev)
            prev = e
    if c1 > prev:
        gaps.append((prev, c1))
    # one sweep over gaps and spans, both in time order, with the open
    # spans on a stack (a thread's spans nest)
    spans = sorted(((e[2], e[2] + e[3], e[1]) for e in events
                    if e[0] == "user_annotation" and e[4] == main
                    and e[1].startswith(prefix)),
                   key=lambda sp: (sp[0], -sp[1]))
    idle, stack, k = {}, [], 0
    for g0, g1 in gaps:
        while k < len(spans) and spans[k][0] <= g0:
            while stack and stack[-1][1] <= spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        label = stack[-1][2] if stack else "(no span)"
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e6
    return busy / 1e6, (c1 - c0) / 1e6, idle


class _TimerHandle:
    """Registers values produced INSIDE a time_block to wait for at exit."""

    def __init__(self):
        self._watched = []

    def watch(self, x):
        """Register a tensor or a (nested) tuple, list or dict of them;
        returns it unchanged. The block's timer stops only after their
        device work is done."""
        self._watched.append(x)
        return x


def _cuda_devices(x, found: set):
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            found.add(x.device)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, found)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)


@contextlib.contextmanager
def time_block(name: str, sync=None):
    """Wall-clock timer. The card's work is asynchronous: register the
    block's own results through the yielded handle (`with time_block("step")
    as tb: y = tb.watch(f(x))`) and the exit synchronizes every card they
    live on before it reads the clock; `sync=` does the same for values
    that exist at entry."""
    handle = _TimerHandle()
    t0 = time.perf_counter()
    yield handle
    found = set()
    _cuda_devices(handle._watched, found)
    _cuda_devices(sync, found)
    for dev in found:
        torch.cuda.synchronize(dev)
    _TIMERS[name].append(time.perf_counter() - t0)


def timer_stats(name: str) -> dict:
    v = _TIMERS.get(name, [])
    if not v:
        return {}
    return {
        "count": len(v),
        "mean_s": sum(v) / len(v),
        "min_s": min(v),
        "total_s": sum(v),
    }


def reset_timers():
    _TIMERS.clear()
