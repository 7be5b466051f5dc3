"""The plain reference (plainref/) tracks a tiny pair as the port's plain
path does, bit for bit on the CPU, and a run on the CPU is correct."""

import numpy as np
import pytest

import harness
import tiny


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "CACHE", tmp_path / "frames")


def test_reference_equals_the_ports_plain_path(tmp_path):
    import check

    cfg = tiny.config()
    root = harness.ensure_frames("tiny-room0", cfg)
    window = harness.Window(tiny.cell(), cfg, root, tmp_path / "w", "cpu")
    run = window.run_clip(0)
    refs = check.reference_pairs(window, [(0, 0), (0, 1)], "cpu")
    for j in (0, 1):
        np.testing.assert_array_equal(
            np.asarray(run.result.poses_est[j], np.float64),
            refs[(0, j)]["best_c2w"])
        assert refs[(0, j)]["steps"] == run.result.steps[j]
        assert refs[(0, j)]["selects"] == run.result.selects[j]


def test_a_cpu_run_is_correct_and_keeps_the_contract():
    out = tiny.run()
    assert out["correct"] is True
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["attempted"] == 4 and out["failed"] == 0
    assert set(out["metrics"]) == {"pair_ms", "peak_mem_mib", "setup_s"} - {
        "peak_mem_mib"}  # no device memory on the CPU
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
