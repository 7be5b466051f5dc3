"""replay_share: the launched steps of the window served by CUDA graph
replays (`stage_s["replayed"]`) over the launched steps
(`stage_s["launched"]`): how often the loop's staged K-cover step runs
from its captured graphs, a share between 0 and 1. Nothing to read where
the program does not count replays."""


def read(rec):
    s = rec.stage_s
    if not s.get("launched") or "replayed" not in s:
        return None
    return s["replayed"] / s["launched"]
