"""The configuration's tracking path, read from the fields the port reads,
chooses the plain reference (plainref/paths/<path>.py); a path with no
reference stops a run, and a calibration, in set-up, before any frame is
written or pair tracked, with a message that names the path and the file
looked for."""

import pytest

import calibrate
import harness
import tiny


@pytest.mark.parametrize("backend,tracking,path", [
    ("fused", {}, "kcover"),
    ("fused", {"max_steps": 2000}, "kcover"),
    ("fused", {"kcover": 12}, "kcover"),
    ("fused", {"kcover": 0}, "subtile"),
    ("fused", {"subtile": False}, "fulltile"),
    ("fused", {"subtile": False, "compact": True}, "fulltile"),
    ("fused", {"subtile": False, "kcover": 0}, "fulltile"),
    ("pallas", {}, "general"),
    ("reference", {"subtile": False}, "general"),
])
def test_the_path_follows_the_ports_own_fields(backend, tracking, path):
    assert harness.tracking_path(
        {"backend": backend, "tracking": tracking}) == path


def sub_tile_config() -> dict:
    cfg = tiny.config()
    cfg["tracking"] = dict(cfg["tracking"], kcover=0)
    return cfg


@pytest.fixture
def nothing_runs(tmp_path, monkeypatch):
    """Records every frame cache and clip a run starts."""
    monkeypatch.setattr(harness, "CACHE", tmp_path / "frames")
    started = []
    monkeypatch.setattr(harness, "ensure_frames",
                        lambda *a, **k: started.append("frames"))
    monkeypatch.setattr(harness.Window, "run_clip",
                        lambda self, *a, **k: started.append("pair"))
    monkeypatch.setattr(harness.Window, "__init__",
                        lambda self, *a, **k: started.append("window"))
    return started


def test_a_path_without_a_reference_stops_the_run(nothing_runs):
    import run as bench_run

    assert not (harness.HERE / "plainref" / "paths" / "subtile.py").exists()
    with pytest.raises(harness.MissingReference,
                       match=r"'subtile'.*benchmarks/plainref/paths/"
                             r"subtile\.py is missing"):
        bench_run.run("room0-stream", 7, 0.01, False, device="cpu",
                      cell_=tiny.cell(), cfg_=sub_tile_config())
    assert nothing_runs == []


def test_a_path_without_a_reference_stops_the_calibration(nothing_runs,
                                                           tmp_path):
    with pytest.raises(harness.MissingReference, match="'subtile'"):
        calibrate.calibrate(tiny.cell(), sub_tile_config(), tmp_path,
                            tmp_path / "w", "cpu", emit=lambda _s: None)
    assert nothing_runs == []
