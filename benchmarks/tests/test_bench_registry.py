"""The harness finds every cell, configuration, metric, path reference and
roofline group of BENCHMARK.json from its file, and a new file by its name
alone."""

import json
import shutil
import sys
import types

import harness
import tracer


def test_every_entry_has_its_file():
    bench = harness.spec()
    for c in bench["configs"]:
        cfg = harness.config(c["name"])
        assert (harness.ROOT / c["file"]).resolve() == (
            harness.HERE / "configs" / f"{c['name']}.json").resolve()
        assert harness.adapter(cfg).write_cache
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
    for w in bench["workloads"]:
        cell = harness.cell(w["name"])
        assert cell["config"] == w["config"]
        assert harness.clip_frames(cell)
        assert set(cell["limits"]) == {"pose_gap_cm", "rot_gap_deg",
                                       "missing_pairs"}
        assert cell["pass_s"] > 0
        # a traced run tracks one pair more than it traces
        assert cell["traced_pairs"] + 1 <= cell["clips"][
            cell["traced_clip"]][1]
        # the configuration's tracking path has its plain reference
        ref = harness.reference(harness.tracking_path(harness.config(
            w["config"])))
        assert callable(ref.track_pair)
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert callable(harness.reader(m["name"]))
    # every roofline group the tracer finds, and the groups the rooflines
    # read
    names = {m["name"] for m in bench["per_layer"]}
    for name, group in tracer.groups().items():
        assert f"{name}_roofline" in names
        assert group.HOOKS and group.KERNELS
        assert callable(group.hold) and callable(group.bound)


def test_clips_fit_their_sequence():
    for w in harness.spec()["workloads"]:
        cell = harness.cell(w["name"])
        cfg = harness.config(cell["config"])
        n = cfg["frames"] if cfg["dataset"] == "replica" else 34
        for frames in harness.clip_frames(cell):
            assert frames[-1] < n


def test_new_files_need_no_edit(tmp_path, monkeypatch):
    here = tmp_path / "benchmarks"
    for sub in ("metrics", "cells", "rooflines", "plainref/paths"):
        shutil.copytree(harness.HERE / sub, here / sub)
    (here / "metrics" / "pairs_done.py").write_text(
        "def read(rec):\n    return rec.pairs or None\n")
    (here / "metrics" / "nothing_read.py").write_text(
        "def read(rec):\n    return None\n")
    cell = json.loads((here / "cells" / "room0-stream.json").read_text())
    cell["stride"] = 2
    (here / "cells" / "room0-stride2.json").write_text(json.dumps(cell))
    monkeypatch.setattr(harness, "HERE", here)
    rec = harness.Record(pairs=7)
    assert harness.reader("pairs_done")(rec) == 7
    assert harness.cell("room0-stride2")["stride"] == 2
    bench = {"end_to_end": [], "per_layer": [
        {"name": "pairs_done", "unit": "count"},
        {"name": "nothing_read", "unit": "count"}]}
    # a reader that finds nothing leaves its metric out of the line
    assert harness.read_metrics(bench, True, rec) == {
        "pairs_done": {"value": 7.0, "unit": "count"}}
    assert harness.read_metrics(bench, False, rec) == {}

    # a tracking path's reference, found by the path's name
    (here / "plainref" / "paths" / "subtile.py").write_text(
        "def track_pair(*args):\n    return 'the sub-tile loop'\n")
    assert harness.reference("subtile").track_pair() == "the sub-tile loop"

    # a roofline group: hooked, held, matched to its kernels and bounded,
    # while the groups whose hooks saw no call read nothing
    probe = types.ModuleType("bench_probe_ops")
    probe.launch = lambda x, scale=1: x * scale
    monkeypatch.setitem(sys.modules, "bench_probe_ops", probe)
    (here / "rooflines" / "kprobe.py").write_text(
        "HOOKS = [('bench_probe_ops', 'launch')]\n"
        "KERNELS = ('probe_kernel', 'probe_tail')\n"
        "def hold(x, scale=1):\n    return x\n"
        "def bound(held, window):\n    return held * window\n")
    groups = tracer.groups()
    assert {"kprobe", "kstep", "kselect"} <= set(groups)
    launches = tracer.Launches(groups)
    undo = tracer.instrument(launches)
    try:
        launches.on = True
        assert [probe.launch(x) for x in (1.0, 2.0, 3.0, 4.0)] == [
            1.0, 2.0, 3.0, 4.0]
    finally:
        tracer.restore(undo)
    assert probe.launch(5.0, scale=2) == 10.0  # restored
    # held on its own 1st, 2nd and 4th call
    assert launches.held["kprobe"] == [1.0, 2.0, None, 4.0]
    kernels = [("kernel", f"gsl::{frag}_x", 10.0 * i + j, 1000.0 * (i + 1),
                0) for i in range(4)
               for j, frag in enumerate(("probe_kernel", "probe_tail"))]
    assert tracer._roofline_inputs(launches, kernels, 0.5) == {
        "kprobe": {"bound_ms": 0.5 + 1.0 + 2.0,
                   "device_ms": 2.0 + 4.0 + 8.0, "launches": 3}}
    # a count mismatch drops the group
    assert tracer._roofline_inputs(launches, kernels[1:], 0.5) == {}


def test_seed_plan_is_the_seeds():
    cell = harness.cell("room0-stream")
    big = 2**33 + 12345
    assert harness.seed_plan(big, cell) == harness.seed_plan(big, cell)
    orders = {tuple(harness.seed_plan(s, cell)[0]) for s in range(20)}
    assert len(orders) > 1
    for s in range(20):
        assert sorted(harness.seed_plan(s, cell)[0]) == list(
            range(len(cell["clips"])))


def test_a_window_is_whole_passes_fixed_by_seconds(tmp_path):
    """ceil(seconds / pass_s) passes, however fast the clips run."""
    cell = dict(harness.cell("room0-stream"), pass_s=10)
    window = harness.Window.__new__(harness.Window)
    window.cell = cell
    ran = []
    window.run_clip = lambda i: ran.append(i) or harness.ClipRun(
        i, [0, 1], type("R", (), {"poses_est": [0], "steps": [1],
                                  "selects": [1], "stage_s": {}})())
    for seconds, passes in ((0.01, 1), (10, 1), (10.5, 2), (51, 6)):
        ran.clear()
        rec = harness.Record()
        window.measure([2, 0, 1], seconds, rec, lambda: None)
        assert rec.passes == passes and ran == [2, 0, 1] * passes
