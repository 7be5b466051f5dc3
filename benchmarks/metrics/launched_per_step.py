"""launched_per_step: the steps the tracking loop enqueued in the window
(`stage_s["launched"]`, the sum of every segment's range) over the steps
it ran: the steps launched and then masked out after a segment's select
gate tripped, as a ratio >= 1."""


def read(rec):
    steps = sum(rec.steps)
    if not steps or "launched" not in rec.stage_s:
        return None
    return rec.stage_s["launched"] / steps
