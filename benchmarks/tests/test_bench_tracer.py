"""The traced stretch: the pairs after a new runner's first, under the
benchmark's own spans, and a run that stops where a span or launch hook
cannot be attached."""

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
        tracer.instrument(tracer.Launches())
    assert kc.build_kcover_buffer is before
