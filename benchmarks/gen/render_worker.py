"""Render worker of `pool.py`, run as a script in a fresh interpreter:

    python benchmarks/gen/render_worker.py

Reads pickled jobs from stdin, one at a time: the keyword arguments of
`synthetic.box_room_frame`. Writes one pickled reply per job to stdout:
("ok", bgr uint8, depth float32) or ("error", traceback). Exits at the end
of its input. Imports numpy and scipy only (frozen copy of
`gsplatloc_tpu_torch/data/fixture_worker.py`).
"""

import pickle
import sys
import traceback
from pathlib import Path


def main():
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np
    from synthetic import box_room_frame

    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    sys.stdout = sys.stderr  # nothing but replies goes down the pipe
    while True:
        try:
            job = pickle.load(stdin)
        except EOFError:
            return
        try:
            rgb, depth = box_room_frame(**job)
            reply = ("ok", (rgb[..., ::-1] * 255).astype(np.uint8), depth)
        except Exception:  # the parent raises it with this traceback
            reply = ("error", traceback.format_exc())
        pickle.dump(reply, stdout, protocol=pickle.HIGHEST_PROTOCOL)
        stdout.flush()


if __name__ == "__main__":
    main()
