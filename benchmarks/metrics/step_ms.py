"""step_ms: the runner's `optimize` stage over the steps run in the
window (loop control, step render, loss, Adam, rebuilds and selects
together), ms per step run."""


def read(rec):
    steps = sum(rec.steps)
    if not steps or "optimize" not in rec.stage_s:
        return None
    return rec.stage_s["optimize"] / steps * 1e3
