"""backward_ms: the loop's `gsl.backward` spans (`torch.autograd.grad`,
which launches K2 and the backward of the loss and the pose) over the
window's launched steps, host ms per launched step."""


def read(rec):
    s = rec.stage_s
    if not s.get("launched") or "backward" not in s:
        return None
    return s["backward"] / s["launched"] * 1e3
