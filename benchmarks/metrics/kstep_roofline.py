"""kstep_roofline: K1 + K2's least time (bounds.step_bounds of each
sampled step's own cover buffer and camera) over their device time in the
trace for the same steps, %."""


def read(rec):
    t = (rec.trace or {}).get("kstep")
    if not t or t["device_ms"] <= 0:
        return None
    return 100.0 * t["bound_ms"] / t["device_ms"]
