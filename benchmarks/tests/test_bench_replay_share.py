"""replay_share (metrics/replay_share.py): a traced run of the tiny cell on
the CPU, where the staged K-cover step runs eagerly, reads 0; a record
with replays reads their share of the launched steps; a record without
the program's `replayed` count, or with no launched step, reads
nothing."""

import pytest

import harness
import tiny


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "CACHE", tmp_path / "frames")


def test_a_traced_cpu_run_reads_no_replay():
    out = tiny.run(trace=True)
    assert out["correct"] is True
    assert out["metrics"]["replay_share"]["value"] == 0.0


@pytest.mark.parametrize("stage_s,expect", [
    ({"launched": 400, "replayed": 396}, 0.99),
    ({"launched": 400, "replayed": 0}, 0.0),
    ({"launched": 400}, None),
    ({"launched": 0, "replayed": 0}, None),
    ({"replayed": 3}, None),
])
def test_the_share_of_replayed_launched_steps(stage_s, expect):
    rec = harness.Record(pairs=2, steps=[150, 150], stage_s=dict(
        stage_s, optimize=2.0))
    assert harness.reader("replay_share")(rec) == expect
