"""read_ms: the loop's `gsl.read` spans (each segment's one host read,
where the host waits for the card) over the window's pairs, ms per
pair."""


def read(rec):
    if not rec.pairs or "read" not in rec.stage_s:
        return None
    return rec.stage_s["read"] / rec.pairs * 1e3
