"""A tiny room0 cell for the CPU tests: 48x64 frames, 120 steps a pair,
two clips of two pairs; its frames under the test's cache folder."""

import harness


def config() -> dict:
    cfg = harness.config("replica-room0")
    cfg.update(height=48, width=64, fx=32.0, fy=32.0, frames=6)
    cfg["tracking"] = {"max_steps": 120}
    return cfg


def cell() -> dict:
    c = harness.cell("room0-stream")
    c.update(config="tiny-room0", clips=[[0, 2], [3, 2]], checked_pairs=2)
    return c


def run(seed=7, trace=False, cell_=None):
    import run as bench_run

    return bench_run.run("room0-stream", seed, 0.01, trace, device="cpu",
                         cell_=cell_ or cell(), cfg_=config())
