"""The Replica-format fixture suite as a file-less dataset.

The port's counterpart of `scripts/make_replica_fixture.py`: that script
writes each room's frames as files (JPEG colour, 16-bit PNG depth over the
scale 6553.5, `traj.txt` poses printed with 9 decimals) and `Replica`
decodes them with OpenCV. `ReplicaFixture(name)` yields frame i exactly as
`Replica` returns it after the script wrote the room, with no file and no
OpenCV:

  * depth: the float32 render, plus (rooms with noise) the i-th draw of
    `default_rng(seed + 1000).normal(0, noise, (H, W))` cast to float32 and
    added in float32 — the draws are taken in frame order whatever order
    frames are read in — then `clip(depth * 6553.5, 0, 65535)` truncated to
    uint16 and divided by the scale in float64;
  * pose: the trajectory's float32 pose printed with 9 decimals, read back
    with float() and cast to float32, as `traj.txt` round-trips it;
  * colour: the uint8 BGR image before its JPEG encoding, as float64 (the
    loader keeps BGR, as the reference does). Colour reaches only the SH DC
    term and the tracking loss is depth-only, so the JPEG error the files
    add does not reach the pose;
  * K: the camera block of the script's `cam_params.json` through
    `BaseDataset`'s intrinsics path (no crop, no distortion).

Frames are rendered ahead of the reader by a pool of worker processes:
fresh interpreters running `fixture_worker.py`, which imports numpy and
scipy only. They are started as new programs, never forked from this
process (which may hold a CUDA context); multiprocessing's spawn start
would re-import this program's main module, and with it torch, in every
worker. A dense room takes tens of seconds of one core per frame at
1200x680, so the look-ahead keeps rendering off the tracking's critical
path where the cores allow; what it does not hide shows in the runner's
`decode` stage.
"""

from __future__ import annotations

import os
import pickle
import queue
import subprocess
import sys
import threading
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .base import RGBDFrame
from .datasets import BaseDataset, Replica
from .synthetic import box_room_trajectory

# name: (clutter_spheres, speed, depth_noise_sigma_m, seed, boxes), the
# table of scripts/make_replica_fixture.py
ROOMS = {
    "room0": (60, 1.0, 0.0, 3, 0),       # tuning scene
    "room1": (20, 3.0, 0.0, 7, 0),       # fast/sparse (~30 mm/frame)
    "room2": (120, 0.35, 0.003, 11, 0),  # slow/dense/noisy
    "office0": (10, 0.8, 0.0, 17, 25),   # desks+some spheres
    "office1": (0, 1.5, 0.001, 19, 40),  # pure furniture, mild noise
    "office2": (30, 0.5, 0.002, 23, 15),  # mixed, slow, noisier
    "office3": (6, 2.0, 0.0, 29, 30),    # sparse + fast motion
    "office4": (20, 1.0, 0.003, 31, 50),  # dense furniture + 3 mm noise
    # ~7x room0's clutter, no noise; dense1 the same class off dense0's
    # seed at 1.5x the motion
    "dense0": (400, 1.0, 0.0, 37, 150),
    "dense1": (400, 1.5, 0.0, 41, 150),
}

# the depth PNG's scale (metres * SCALE = uint16 value)
SCALE = 6553.5

WORKER = Path(__file__).resolve().with_name("fixture_worker.py")


def camera_config(height: int = 680, width: int = 1200) -> dict:
    """The camera block of the fixture's cam_params.json."""
    fx = fy = 600.0 * (width / 1200.0)
    cx, cy = width / 2 - 0.5, height / 2 - 0.5
    return {"w": width, "h": height, "fx": fx, "fy": fy, "cx": cx, "cy": cy,
            "scale": SCALE}


def default_workers() -> int:
    """Render processes: the cores this process may use less two (the
    tracking loop and the kNN), at least one, at most eight."""
    return max(1, min(8, len(os.sched_getaffinity(0)) - 2))


class RenderPool:
    """Worker processes that render box-room frames, one job each at a
    time; `submit` returns a Future of (bgr uint8, depth float32)."""

    def __init__(self, workers: int):
        self.workers = workers
        self._threads = ThreadPoolExecutor(workers,
                                           thread_name_prefix="fixture")
        self._idle = queue.SimpleQueue()
        self._procs = []
        self._lock = threading.Lock()

    def _start(self):
        # one BLAS / OpenMP thread each: the pool is the parallelism
        env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
                   MKL_NUM_THREADS="1")
        proc = subprocess.Popen([sys.executable, str(WORKER)],
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                env=env)
        self._procs.append(proc)
        return proc

    def _run(self, job):
        with self._lock:
            proc = (self._start() if self._idle.empty()
                    and len(self._procs) < self.workers else None)
        if proc is None:
            proc = self._idle.get()
        try:
            pickle.dump(job, proc.stdin, protocol=pickle.HIGHEST_PROTOCOL)
            proc.stdin.flush()
            reply = pickle.load(proc.stdout)
        except (EOFError, BrokenPipeError) as e:
            with self._lock:  # the next job starts a new worker
                self._procs.remove(proc)
            raise RuntimeError(f"fixture render worker {proc.pid} ended "
                               f"(exit code {proc.poll()})") from e
        self._idle.put(proc)
        if reply[0] != "ok":
            raise RuntimeError(f"fixture render failed:\n{reply[1]}")
        return reply[1], reply[2]

    def submit(self, **job) -> Future:
        return self._threads.submit(self._run, job)

    def close(self):
        """Cancel what has not started, finish what has, stop the workers."""
        self._threads.shutdown(wait=True, cancel_futures=True)
        for proc in self._procs:
            proc.stdin.close()
        for proc in self._procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            proc.stdout.close()
        self._procs.clear()


class ReplicaFixture(BaseDataset):
    """Sequence[RGBDFrame] of one fixture room, equal to what `Replica`
    reads from the files `scripts/make_replica_fixture.py` writes for it
    (depth and pose bit for bit; colour before the JPEG encoding)."""

    ROOMS = Replica.ROOMS + ["dense0", "dense1"]

    def __init__(self, name: str = "room0", *, frames: int = 80,
                 height: int = 680, width: int = 1200,
                 workers: int | None = None):
        if name not in ROOMS:
            raise ValueError(f"unknown fixture room {name!r}; one of "
                             f"{list(ROOMS)}")
        self.name = name
        self.input_folder = Path(f"<fixture:{name}>")
        self._init_camera(camera_config(height, width))
        self._h, self._w = height, width
        self._clutter, speed, self._noise, seed, self._boxes = ROOMS[name]
        self._render_poses = box_room_trajectory(frames, seed=seed,
                                                 speed=speed)
        # traj.txt's text round trip
        self._poses = [
            np.array([float(f"{v:.9f}") for v in np.asarray(c2w).ravel()])
            .reshape(4, 4) for c2w in self._render_poses]
        # noise draws in frame order: the generator's state before draw i
        self._noise_rng = np.random.default_rng(seed + 1000)
        self._noise_states = [self._noise_rng.bit_generator.state]
        self._lock = threading.Lock()
        self._pending = {}  # frame index -> Future of the raw render
        self._pool = RenderPool(workers or default_workers())
        # the lead over the reader: enough to keep every worker busy
        self._ahead = 2 * self._pool.workers
        self._finalizer = weakref.finalize(self, self._pool.close)

    def __str__(self):
        return f"Replica fixture: {self.name} ({len(self)} frames)"

    def __len__(self):
        return len(self._render_poses)

    def close(self):
        """Stop the render workers (also done when the dataset is
        collected, and at exit)."""
        self._finalizer()

    def _submit(self, index: int):
        if index not in self._pending:
            self._pending[index] = self._pool.submit(
                # self.K is also the float32 K the script renders with
                c2w=self._render_poses[index], K=self.K,
                height=self._h, width=self._w, clutter=self._clutter,
                boxes=self._boxes)

    def _noise_draw(self, index: int) -> np.ndarray:
        """The index-th draw of the room's depth noise, float32 (H, W)."""
        rng, states = self._noise_rng, self._noise_states
        while len(states) <= index:  # draws before it, in frame order
            rng.bit_generator.state = states[-1]
            rng.normal(0.0, self._noise, (self._h, self._w))
            states.append(rng.bit_generator.state)
        rng.bit_generator.state = states[index]
        draw = rng.normal(0.0, self._noise, (self._h, self._w))
        if len(states) == index + 1:
            states.append(rng.bit_generator.state)
        return draw.astype(np.float32)

    def _get_one(self, index: int) -> RGBDFrame:
        with self._lock:
            for j in range(index, min(index + self._ahead + 1, len(self))):
                self._submit(j)
            fut = self._pending.pop(index)
        bgr, depth = fut.result()
        if self._noise > 0:
            with self._lock:
                depth = depth + self._noise_draw(index)
        d16 = np.clip(depth * SCALE, 0, 65535).astype(np.uint16)
        return RGBDFrame(rgb=bgr.astype(np.float64),
                         depth=d16.astype(np.float64) / self.scale,
                         K=self.K, c2w=self._poses[index].astype(np.float32))
