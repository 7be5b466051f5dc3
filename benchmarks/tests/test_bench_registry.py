"""The harness finds every cell, configuration and metric of
BENCHMARK.json from its file, and a new file by its name alone."""

import json
import shutil

import harness


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
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert callable(harness.reader(m["name"]))


def test_clips_fit_their_sequence():
    for w in harness.spec()["workloads"]:
        cell = harness.cell(w["name"])
        cfg = harness.config(cell["config"])
        n = cfg["frames"] if cfg["dataset"] == "replica" else 34
        for frames in harness.clip_frames(cell):
            assert frames[-1] < n


def test_new_files_need_no_edit(tmp_path, monkeypatch):
    here = tmp_path / "benchmarks"
    shutil.copytree(harness.HERE / "metrics", here / "metrics")
    shutil.copytree(harness.HERE / "cells", here / "cells")
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
