"""The check's control: the plain reference put in the port's place with
TF32 matmuls and convolutions (the configurations' float32 with TF32 off,
one step down) comes out not correct under a cell's limits on every pair,
where the port comes out correct, read and judged by calibrate.py through
check.readings and check.judge. On the card at a fifth of room0's width
and height (calibrate.py reads the same at the cells' own sizes); on the
CPU, at the tiny cell, the port is the reference bit for bit."""

import pytest

import calibrate
import harness
import tiny


@pytest.mark.chip
def test_tf32_control_is_not_correct(cuda_device, tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "CACHE", tmp_path / "frames")
    cfg = harness.config("replica-room0")
    cfg.update(height=136, width=240, fx=120.0, fy=120.0, frames=4)
    cell = harness.cell("room0-stream")
    cell.update(config="fifth-room0", clips=[[0, 3]])
    root = harness.ensure_frames("fifth-room0", cfg)
    s = calibrate.calibrate(cell, cfg, root, tmp_path / "w", cuda_device,
                            emit=lambda _s: None)
    assert s["port_fails"] == [] and s["tf32_passes"] == [], s


def test_calibration_reads_every_pair_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "CACHE", tmp_path / "frames")
    cfg = tiny.config()
    root = harness.ensure_frames("tiny-room0", cfg)
    cell = dict(tiny.cell(), clips=[[0, 2]])
    rows = []
    s = calibrate.calibrate(cell, cfg, root, tmp_path / "w", "cpu",
                            emit=rows.append)
    assert len(rows) == 3  # two pairs and the summary
    assert s["lower"] == {"pose_gap_cm": 0.0, "rot_gap_deg": 0.0}
    assert s["port_fails"] == []
