"""The port's spans and counters (utils/profiling.py:span): the tracking
loop's spans counted against PairResult's counts on every tracking path,
results bitwise equal with a profiler recording and without one, no
profiler range opened while none records, the runner's stage keys and its
worker's spans, the idle split of a trace by span, and `cli track
--profile`."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gsplatloc_tpu_torch import cli
from gsplatloc_tpu_torch.data.parser import render_depth_gt
from gsplatloc_tpu_torch.data.synthetic import box_room_frame
from gsplatloc_tpu_torch.models.gaussians import scene_from_point_cloud
from gsplatloc_tpu_torch.opt.tracking import (
    HOST_KEYS, TrackingConfig, optimize_pose,
)
from gsplatloc_tpu_torch.ops.camera import depth_to_points
from gsplatloc_tpu_torch.tracking import runner as trunner
from gsplatloc_tpu_torch.tracking.runner import SequenceRunner
from gsplatloc_tpu_torch.utils import profiling
from torch_port_helpers import intrinsics, perturbed_c2w

H, W = 48, 64
STEP_CHILDREN = ("gsl.render", "gsl.loss", "gsl.backward", "gsl.adam")
# (backend, TrackingConfig fields) of each tracking path
PATHS = {
    "kcover": ("fused", dict(kcover=16)),
    "kcover0": ("fused", dict(kcover=0)),
    "fulltile": ("fused", dict(subtile=False)),
    "general": ("pallas", dict(max_steps=10)),
}


@pytest.fixture(scope="module")
def pair():
    """A box-room frame as a frozen scene (the port alone), its depth seen
    from a displaced camera as the target."""
    K = intrinsics(H, W)
    rgb, depth = box_room_frame(np.eye(4), K, H, W, clutter=10)
    pts = depth_to_points(torch.as_tensor(depth, dtype=torch.float32),
                          torch.as_tensor(K))
    cols = torch.as_tensor(rgb.reshape(-1, 3), dtype=torch.float32)
    scene = scene_from_point_cloud(pts, cols, grid_shape=(H, W),
                                   device="cpu")
    depth_gt = render_depth_gt(pts, cols, K, perturbed_c2w(
        (0.7, -0.4, 0.3), (0.012, -0.01, 0.018)), H, W, grid_shape=(H, W),
        backend="subtile", device="cpu")
    return scene, K, depth_gt


def _track(pair, path):
    scene, K, depth_gt = pair
    backend, kw = PATHS[path]
    # a rebuild at every segment boundary and a tight select gate, so the
    # K-cover path re-selects inside segments and masks steps
    cfg = TrackingConfig(**dict(dict(
        max_steps=20, patience=20, warmup_steps=5, resort_every=5,
        resort_motion_px=0.0, select_motion_px=0.5), **kw))
    return optimize_pose(scene, np.eye(4, dtype=np.float32), depth_gt, K, W,
                         H, config=cfg, backend=backend, device="cpu")


def _annotations(prof):
    """(name, start_ns, end_ns, thread) of the profile's gsl.* ranges."""
    return [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.activity_type() == "user_annotation"
            and e.name().startswith("gsl.")]


@pytest.fixture(scope="module")
def runs(pair):
    """{path: (result without a profiler, result under one, its ranges)}."""
    out = {}
    for path in PATHS:
        off = _track(pair, path)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = _track(pair, path)
        out[path] = (off, on, _annotations(prof))
    return out


@pytest.mark.parametrize("path", list(PATHS))
def test_loop_spans_match_the_pair_result_counts(runs, path):
    _off, res, spans = runs[path]
    n = {}
    for name, *_ in spans:
        n[name] = n.get(name, 0) + 1
    assert res.launched >= res.steps_run > 0
    assert n["gsl.step"] == res.launched
    for child in STEP_CHILDREN:
        assert n[child] == res.launched
    assert n["gsl.segment"] == n["gsl.read"] == res.segments > 0
    if path == "general":
        assert "gsl.rebuild" not in n and "gsl.select" not in n
    else:
        assert n["gsl.rebuild"] == res.rebuilds + 1
        assert n.get("gsl.select", 0) == (res.selects + 1 if path == "kcover"
                                          else 0)
    steps = [s for s in spans if s[0] == "gsl.step"]
    for name, t0, t1, tid in spans:
        if name in STEP_CHILDREN:
            assert any(s0 <= t0 and t1 <= s1 and stid == tid
                       for _n, s0, s1, stid in steps), name
    # the loop's host seconds: every key, each step's own time >= 0
    assert set(res.host_s) == set(HOST_KEYS)
    assert res.host_s["step"] >= sum(res.host_s[k[4:]]
                                     for k in STEP_CHILDREN) > 0


@pytest.mark.parametrize("path", list(PATHS))
def test_profiler_leaves_results_bitwise_equal(runs, path):
    off, on, _spans = runs[path]
    for name in ("steps_run", "rebuilds", "selects", "slot_overflow",
                 "launched", "segments"):
        assert getattr(on, name) == getattr(off, name), name
    for name in ("best_pose", "final_pose"):
        for a, b in zip(getattr(on, name), getattr(off, name)):
            assert torch.equal(a, b), name
    for name in ("best_loss", "best_depth_loss", "best_silhouette_loss"):
        assert torch.equal(getattr(on, name), getattr(off, name)), name


def test_spans_open_no_range_without_a_profiler(pair, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    into = {}
    with profiling.span("gsl.unit", into, args=3):
        pass
    with profiling.span("gsl.unit", into):
        pass
    assert set(into) == {"unit"} and into["unit"] > 0
    res = _track(pair, "kcover")
    assert res.host_s["step"] > 0 and res.host_s["read"] > 0


def test_runner_stage_keys_and_worker_spans(tmp_path, monkeypatch):
    outs, ranges = [], []
    real_opt, real_rf = trunner.optimize_pose, profiling.record_function

    def opt(*a, **k):
        outs.append(real_opt(*a, **k))
        return outs[-1]

    def rf(name, args=None):
        ranges.append((name, args, threading.get_ident()))
        return real_rf(name, args)

    monkeypatch.setattr(trunner, "optimize_pose", opt)
    monkeypatch.setattr(profiling, "record_function", rf)
    r = SequenceRunner(data_set="Synthetic", scene_name="", height=H,
                       width=W, speed=8.0, n_frames=3, max_pairs=2,
                       config=TrackingConfig(max_steps=10, warmup_steps=5),
                       run_dir=tmp_path / "run", device="cpu")
    with profiling.profile_trace(tmp_path / "prof", device="cpu"):
        res = r.train(progress=False, prefetch=True)
    assert set(res.stage_s) == {
        "wait", "decode", "knn", "parse", "scene", "optimize", "collect",
        *HOST_KEYS, "launched", "segments", "replayed"}
    assert res.stage_s["launched"] == sum(o.launched for o in outs) > 0
    assert res.stage_s["segments"] == sum(o.segments for o in outs) > 0
    # the CPU runs the staged step eagerly
    assert res.stage_s["replayed"] == sum(o.replayed for o in outs) == 0
    main = threading.get_ident()
    assert [a for n, a, t in ranges if n == "gsl.pair" and t == main] == [
        "0", "1"]
    for name in ("gsl.decode", "gsl.knn"):
        assert [(a, t != main) for n, a, t in ranges if n == name] == [
            ("0", True), ("1", True)]
    # in the written trace too: the worker's spans on a thread of their own
    events = profiling.trace_events(tmp_path / "prof" / profiling.TRACE_FILE)
    tid = {e[1]: e[4] for e in events if e[0] == "user_annotation"}
    assert tid["gsl.decode"] == tid["gsl.knn"] != tid["gsl.pair"]


def _ev(cat, name, t0, t1, tid=1):
    return (cat, name, float(t0), float(t1 - t0), tid)


def test_idle_by_span_labels_each_gap_by_the_innermost_open_span():
    """Times in microseconds: the card busy 10-20 and 50-60 of a window
    0-100; the gap 0-10 opens inside gsl.wait, 20-50 inside gsl.step
    (opened at 15 in gsl.optimize), 60-100 inside gsl.read (gsl.step
    closed at 55). Other threads' spans and other prefixes do not count."""
    events = [
        _ev("user_annotation", "gsl.pair", 0, 100),
        _ev("user_annotation", "gsl.wait", 0, 12),
        _ev("user_annotation", "gsl.optimize", 12, 100),
        _ev("user_annotation", "gsl.step", 15, 55),
        _ev("user_annotation", "gsl.read", 58, 90),
        _ev("user_annotation", "gsl.decode", 0, 100, tid=2),  # worker
        _ev("user_annotation", "bench.loss", 20, 30),  # not a gsl span
        _ev("kernel", "k1", 10, 20, tid=7),
        _ev("gpu_memcpy", "copy", 15, 18, tid=7),
        _ev("kernel", "k2", 50, 60, tid=7),
        _ev("kernel", "after", 120, 130, tid=7),  # out of the window
    ]
    busy, window, idle = profiling.idle_by_span(events)
    assert (busy, window) == pytest.approx((20e-6, 100e-6))
    assert idle == pytest.approx({"gsl.wait": 10e-6, "gsl.step": 30e-6,
                                  "gsl.read": 40e-6})
    with pytest.raises(ValueError, match="gsl.pair"):
        profiling.idle_by_span(events[1:])


def test_cli_track_profile_writes_the_trace(tmp_path, capsys):
    cli.main(["track", "--device", "cpu", "--dataset", "Synthetic",
              "--frames", "2", "--height", str(H), "--width", str(W),
              "--num-iters", "6", "--knn", "grid", "--quiet",
              "--run-dir", str(tmp_path / "runs"),
              "--profile", str(tmp_path / "prof")])
    assert (tmp_path / "prof" / profiling.TRACE_FILE).exists()
    out = capsys.readouterr().out
    assert "idle by span" in out and "gsl.pair" in out
