"""kselect_roofline: K3's least time (bounds.select_bound of each
sampled select's own slot buffer and camera) over its device time in the
trace for the same launches, %."""


def read(rec):
    t = (rec.trace or {}).get("kselect")
    if not t or t["device_ms"] <= 0:
        return None
    return 100.0 * t["bound_ms"] / t["device_ms"]
