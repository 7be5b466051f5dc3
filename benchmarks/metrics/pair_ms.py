"""pair_ms: the window's wall time over the frame pairs completed in it
(closed loop, prefetch on), in ms. Host clock."""


def read(rec):
    return rec.window_s / rec.pairs * 1e3 if rec.pairs else None
