"""The roofline groups (rooflines/<group>.py) read what the tracer read
when its K1/K2/K3 hooks and bounds were fixed in it: a frozen copy of that
tracer's launch recorder and `_roofline_inputs`, run beside the group loop
on one recorded set of launches (the tiny cell's clip on the CPU, its
kernel times drawn from a seed in launch order), gives the same kstep and
kselect readings to the last digit, and drops the same group on a count
mismatch. A group added beside them, hooked on the same calls, leaves
their samples as they were."""

import functools
import importlib
import types

import numpy as np
import pytest

import harness
import tiny
import tracer

# kernel-name fragments of the launches the rooflines read (frozen)
K1, K2, K2_SUM, K3 = ("kcover_step_fwd_kernel", "kcover_step_bwd_kernel",
                      "sum12_kernel", "kcover_select_kernel")


class FrozenLaunches:
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


def _durations(kernels: list, fragment: str) -> list:
    return [k[3] for k in kernels if fragment in k[1]]


def frozen_roofline_inputs(launches, kernels: list, window) -> dict:
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


# a group a later file could add: on its own clock, hooked on both calls
# that kstep and kselect hook, its kernels not in the trace
EXTRA = types.SimpleNamespace(
    HOOKS=[("gsplatloc_tpu_torch.ops.kcover", "kcover_step_fwd"),
           ("gsplatloc_tpu_torch.ops.kcover", "select_kcover_records")],
    KERNELS=("no_such_kernel",), hold=lambda *a, **k: True,
    bound=lambda held, window: 1.0)


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """(frozen recorder, group recorder, window) of one clip of the tiny
    cell tracked with both recorders hooked at once, the group recorder
    with the EXTRA group beside the files' groups."""
    tmp = tmp_path_factory.mktemp("rooflines")
    cache = harness.CACHE
    harness.CACHE = tmp / "frames"
    try:
        cfg = tiny.config()
        root = harness.ensure_frames("tiny-room0", cfg)
    finally:
        harness.CACHE = cache
    window = harness.Window(tiny.cell(), cfg, root, tmp / "w", "cpu")
    old = FrozenLaunches()
    new = tracer.Launches(dict(tracer.groups(), kextra=EXTRA))
    kc = importlib.import_module("gsplatloc_tpu_torch.ops.kcover")
    undo = tracer.instrument(new)
    try:
        undo.append(tracer._patch(kc, "kcover_step_fwd", old.step_fwd))
        undo.append(tracer._patch(kc, "select_kcover_records", old.select))
        old.on = new.on = True
        window.run_clip(0)
    finally:
        tracer.restore(undo)
    return old, new, window


def kernel_events(n_steps: int, n_selects: int, seed: int = 5) -> list:
    """The trace's kernels of the recorded launches in launch order, each
    step's K1, K2 and K2's reduction and each select's K3, with durations
    (us) drawn from the seed."""
    rng = np.random.default_rng(seed)
    names = [f"gsl::{f}_float" for f in (K1, K2, K2_SUM)]
    out, t = [], 0.0
    for i in range(max(n_steps, n_selects)):
        for name in names * (i < n_steps) + [f"gsl::{K3}_x"] * (
                i < n_selects):
            d = float(rng.uniform(10.0, 400.0))
            out.append(("kernel", name, t, d, 0))
            t += d + 1.0
    return out


@pytest.mark.parametrize("drop", [None, K2, K3, "all"])
def test_groups_read_as_the_frozen_tracer(recorded, drop):
    old, new, window = recorded
    assert len(old.steps) == len(new.held["kstep"]) > 8
    assert len(old.selects) == len(new.held["kselect"]) > 2
    kernels = kernel_events(len(old.steps), len(old.selects))
    if drop == "all":  # a trace without device kernels (the CPU's)
        kernels = []
    elif drop is not None:  # one launch of the group lost from the trace
        k = next(i for i, e in enumerate(kernels) if drop in e[1])
        kernels = kernels[:k] + kernels[k + 1:]
    want = frozen_roofline_inputs(old, kernels, window)
    got = tracer._roofline_inputs(new, kernels, window)
    assert got == want
    assert set(want) == {None: {"kstep", "kselect"}, K2: {"kselect"},
                         K3: {"kstep"}, "all": set()}[drop]
    for g in want.values():
        assert g["bound_ms"] > 0 and g["launches"] >= 2


def test_a_new_group_leaves_the_old_samples(recorded):
    """kstep and kselect hold the very calls the frozen tracer held (its
    shared selection count), though EXTRA's calls came between theirs;
    EXTRA holds its own 1st, 2nd, 4th, ... call."""
    old, new, _window = recorded
    assert [kb is not None for kb, _cam in old.steps] == [
        h is not None for h in new.held["kstep"]]
    assert [a is not None for a in old.selects] == [
        h is not None for h in new.held["kselect"]]
    n = len(old.steps) + len(old.selects)
    assert new.calls["kextra"] == n == len(new.held["kextra"])
    assert [i + 1 for i, h in enumerate(new.held["kextra"]) if h] == [
        2 ** j for j in range(n.bit_length())]
    for (kb, cam), h in zip(old.steps, new.held["kstep"]):
        assert h is None or (h[0] is kb and h[1] is cam)
