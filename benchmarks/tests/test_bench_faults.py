"""A run with the timed path broken underneath comes out not correct: a
step that returns its state unchanged, half of the pairs left out, a pose
altered where it is produced. (The exchange between chips does not exist
on the cells' one chip.)"""

import pytest

import harness
import tiny


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "CACHE", tmp_path / "frames")


def test_step_returns_its_state_unchanged(monkeypatch):
    import gsplatloc_tpu_torch.opt.tracking as tr

    monkeypatch.setattr(tr, "adam_step",
                        lambda param, grad, state, *a, **k: (param, state))
    out = tiny.run()
    assert out["correct"] is False
    assert out["checks"]["pose_gap_cm"]["value"] > out["checks"][
        "pose_gap_cm"]["limit"]


def test_half_the_pairs_left_out(monkeypatch):
    from gsplatloc_tpu_torch.data.parser import Parser

    monkeypatch.setattr(Parser, "__len__",
                        lambda self: (len(self._data) - 1) // 2)
    out = tiny.run()
    assert out["correct"] is False
    assert out["checks"]["missing_pairs"]["value"] > 0


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    import gsplatloc_tpu_torch.tracking.runner as runner

    real = runner.optimize_pose

    def shifted(*a, **k):
        out = real(*a, **k)
        pose = out.best_pose._replace(trans=out.best_pose.trans + 0.002)
        return out._replace(best_pose=pose)

    monkeypatch.setattr(runner, "optimize_pose", shifted)
    out = tiny.run()
    assert out["correct"] is False
