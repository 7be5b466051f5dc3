"""device_idle_pct: the share of the traced clip's wall time in which no
kernel, copy or set runs on the card, from the profiler's timeline, %.
Nothing to read where the trace saw no device work (a run on the CPU)."""


def read(rec):
    t = rec.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
