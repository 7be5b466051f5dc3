"""bookkeep_ms: the self time of the loop's `gsl.step` spans (the in-loop
select gate, the best-loss bookkeeping and the carry mask: the step less
its render, loss, backward and Adam) over the window's launched steps,
host ms per launched step."""

PARTS = ("render", "loss", "backward", "adam")


def read(rec):
    s = rec.stage_s
    if not s.get("launched") or any(k not in s for k in ("step", *PARTS)):
        return None
    return (s["step"] - sum(s[k] for k in PARTS)) / s["launched"] * 1e3
