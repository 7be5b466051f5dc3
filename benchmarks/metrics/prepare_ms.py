"""prepare_ms: the runner's `decode` + `knn` stages over the window's
pairs (the host prepare on the prefetch worker), ms per pair."""


def read(rec):
    keys = ("decode", "knn")
    if not rec.pairs or not all(k in rec.stage_s for k in keys):
        return None
    return sum(rec.stage_s[k] for k in keys) / rec.pairs * 1e3
