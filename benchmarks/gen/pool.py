"""Worker processes that render box-room frames (frozen copy of
`gsplatloc_tpu_torch/data/fixtures.py:RenderPool`). Each worker is a new
interpreter running `render_worker.py`, never a fork of a process that may
hold a CUDA context."""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

WORKER = Path(__file__).resolve().with_name("render_worker.py")


def default_workers() -> int:
    """The cores this process may use less two, at least one, at most 8."""
    return max(1, min(8, len(os.sched_getaffinity(0)) - 2))


def render_frames(jobs: list, workers: int | None = None):
    """Yield (bgr uint8, depth float32) for each job (keyword arguments of
    `synthetic.box_room_frame`) in order, rendered by `workers` processes
    with one BLAS thread each."""
    workers = max(1, min(workers or default_workers(), len(jobs)))
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER)],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              env=env) for _ in range(workers)]

    def run(w, my_jobs):
        proc, out = procs[w], []
        for job in my_jobs:
            pickle.dump(job, proc.stdin, protocol=pickle.HIGHEST_PROTOCOL)
            proc.stdin.flush()
            reply = pickle.load(proc.stdout)
            if reply[0] != "ok":
                raise RuntimeError(f"frame render failed:\n{reply[1]}")
            out.append(reply[1:])
        return out

    try:
        with ThreadPoolExecutor(workers) as ex:
            futs = [ex.submit(run, w, jobs[w::workers])
                    for w in range(workers)]
            parts = [f.result() for f in futs]
        for i in range(len(jobs)):
            yield parts[i % workers][i // workers]
    finally:
        for proc in procs:
            proc.stdin.close()
        for proc in procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            proc.stdout.close()
