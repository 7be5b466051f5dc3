"""wait_ms: the runner's `wait` stage over the window's pairs (host
prepare that the prefetch worker did not hide), ms per pair."""


def read(rec):
    if not rec.pairs or "wait" not in rec.stage_s:
        return None
    return rec.stage_s["wait"] / rec.pairs * 1e3
