"""scene_ms: the runner's `parse` + `scene` stages over the window's
pairs (pair assembly with the depth target, the scene build), ms per
pair."""


def read(rec):
    keys = ("parse", "scene")
    if not rec.pairs or not all(k in rec.stage_s for k in keys):
        return None
    return sum(rec.stage_s[k] for k in keys) / rec.pairs * 1e3
