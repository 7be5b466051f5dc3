"""The traced stretch: the pairs after a new runner's first, under the
benchmark's own spans, a run that stops where a span or launch hook
cannot be attached, and idle gaps labelled by the port's `gsl.*` spans."""

import pytest

import harness
import tiny
import tracer


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "CACHE", tmp_path / "frames")


def traced_cell():
    return dict(tiny.cell(), traced_clip=0, traced_pairs=1)


def test_the_trace_holds_the_pairs_after_the_first(monkeypatch):
    from gsplatloc_tpu_torch.tracking.runner import SequenceRunner

    prepares = []
    real = tracer.summarize

    def seen(events):
        prepares.extend(e for e in events
                        if e[1] == "bench.device_prepare")
        return real(events)

    monkeypatch.setattr(tracer, "summarize", seen)
    before = SequenceRunner._prepare_device
    out = tiny.run(trace=True, cell_=traced_cell())
    assert out["correct"] is True
    # the second pair's device prepare alone: the first is not traced
    assert len(prepares) == 1
    assert SequenceRunner._prepare_device is before
    assert {"wait_ms", "prepare_ms", "scene_ms", "step_ms",
            "selects_per_pair"} <= set(out["metrics"])


def test_a_missing_hook_stops_the_run(monkeypatch):
    import gsplatloc_tpu_torch.ops.kcover as kc

    monkeypatch.delattr(kc, "select_kcover_records")
    before = kc.build_kcover_buffer
    with pytest.raises(AttributeError, match="select_kcover_records"):
        tracer.instrument(tracer.Launches(tracer.groups()))
    assert kc.build_kcover_buffer is before


def test_idle_gaps_take_the_innermost_gsl_span():
    """Each gap on the card goes to the innermost `gsl.*` span of the main
    thread open when it began, to the innermost `bench.*` span outside
    every `gsl.*` one; spans of other threads and closed spans label
    nothing."""
    ua, main, worker = "user_annotation", 1, 2
    events = [
        (ua, "bench.steady", 0, 100, main),
        (ua, "bench.device_prepare", 0, 10, main),
        (ua, "gsl.optimize", 10, 80, main),
        (ua, "bench.optimize", 10, 80, main),
        (ua, "gsl.segment", 12, 30, main),
        (ua, "gsl.step", 14, 6, main),
        (ua, "gsl.read", 36, 4, main),
        (ua, "gsl.decode", 50, 40, worker),
        ("kernel", "k", 1, 4, 0),  # idle 0-1 and 5-15
        ("kernel", "k", 15, 5, 0),  # idle 20-38
        ("kernel", "k", 38, 50, 0),  # idle 88-100
    ]
    readings, breakdown = tracer.summarize(events)
    assert readings == {"busy_s": 59 / 1e6, "window_s": 100 / 1e6}
    assert breakdown["idle_gaps"] == [["gsl.segment", 18 / 1e6],
                                      ["gsl.optimize", 12 / 1e6],
                                      ["bench.device_prepare", 11 / 1e6]]
