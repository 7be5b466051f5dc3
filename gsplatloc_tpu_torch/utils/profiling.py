"""Profiling hooks: torch.profiler traces + wall-clock timers.

`profile_trace(log_dir)` records the block with torch.profiler (host
operations, and the card's kernels when the device is a card) and writes
it as a Chrome trace, `<log_dir>/trace.json` (chrome://tracing, Perfetto).
`time_block(name)` adds the block's wall clock to a registry of named
timers (`timer_stats`) that feeds rays/s-style throughput counters.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch

from .._device import DEFAULT_DEVICE, resolve_device

_TIMERS: dict[str, list[float]] = defaultdict(list)
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir: str | Path = "runs/trace", device=DEFAULT_DEVICE):
    """Trace the block; yields the torch.profiler profile (its
    `key_averages()` sums by operation). The card's work is waited for
    before the trace closes."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(str(out / TRACE_FILE))


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


def rays_per_sec(pixels_per_step: int, step_time_s: float) -> float:
    """Pixels (rays) per second of a step."""
    return pixels_per_step / max(step_time_s, 1e-12)


def reset_timers():
    _TIMERS.clear()
