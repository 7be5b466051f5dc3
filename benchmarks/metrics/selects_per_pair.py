"""selects_per_pair: the mean of SequenceResult.selects over the
window's pairs (cover re-selections that fired)."""


def read(rec):
    return sum(rec.selects) / len(rec.selects) if rec.selects else None
