"""The loop-control metrics read from the port's own spans and counters
(`SequenceResult.stage_s`): a traced run of the tiny cell reports each,
finite, with launched_per_step at least 1; a record without the port's
keys (a program that lacks the spans) reports none of them."""

import math

import pytest

import harness
import tiny

LOOP = ("launched_per_step", "backward_ms", "bookkeep_ms", "read_ms")


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "CACHE", tmp_path / "frames")


def test_a_traced_run_reads_the_loop_metrics():
    out = tiny.run(trace=True)
    assert out["correct"] is True
    m = {k: out["metrics"][k]["value"] for k in LOOP}
    assert all(math.isfinite(v) and v >= 0 for v in m.values()), m
    assert m["launched_per_step"] >= 1
    assert m["backward_ms"] > 0 and m["read_ms"] > 0


@pytest.mark.parametrize("name", LOOP)
def test_a_program_without_the_spans_reads_nothing(name):
    rec = harness.Record(pairs=2, steps=[10, 12], stage_s={
        "wait": 0.1, "decode": 0.2, "knn": 0.3, "parse": 0.1, "scene": 0.1,
        "optimize": 2.0, "collect": 0.1})
    assert harness.reader(name)(rec) is None
