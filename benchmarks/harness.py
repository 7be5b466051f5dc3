"""The benchmark's run: its files found by name, the frame cache, the
set-up, the measured window over `SequenceRunner.train`, and the record
the metric readers read.

Everything that belongs to one configuration, one cell or one metric sits
in a file of its own under this folder, found by the name in
BENCHMARK.json:

    configs/<config>.json   the deployment: dataset layout (an adapter in
                            layouts/<dataset>.py), scene generator, camera,
                            TrackingConfig fields, source and cuts
    cells/<cell>.json       the traffic: configuration, frame stride, the
                            clips of consecutive pairs a pass runs, the
                            nominal seconds of a pass, the pairs the check
                            samples, the clip a traced run profiles
    metrics/<metric>.py     a reader: read(record) -> number or None
    plainref/paths/<path>.py
                            the plain reference of one tracking path
                            (`tracking_path`): the pair's depth target and
                            loop, track_pair(...) -> best pose, steps,
                            selects
    rooflines/<group>.py    one kernel group's roofline (tracer.py): the
                            port's attributes whose calls carry a
                            launch's inputs, its kernels' name fragments,
                            the launch's bound

The window is closed-loop: a pass runs every clip of the cell once, in an
order drawn from the seed, each clip through a new `SequenceRunner` and
its `train(prefetch=True)`, the next clip when the last is done. A window
is ceil(seconds / pass_s) whole passes (at least one), a number fixed by
the cell and --seconds and not by the host's speed, so every run of a
cell does the same pairs.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the frame cache: one fixed folder per configuration, inside the checkout
CACHE = HERE / "_cache" / "frames"
# top-level modules no run may hold: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "gsplatloc_tpu")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    return load_json(HERE / "cells" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def adapter(cfg: dict):
    """The dataset layout module named by the configuration."""
    return importlib.import_module(f"layouts.{cfg['dataset']}")


def load(path: Path, name: str):
    """The module of the file `path`, run under the module name `name`."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The `read` function of metrics/<metric>.py."""
    return load(HERE / "metrics" / f"{metric}.py",
                f"bench_metric_{metric.replace('.', '_').replace('-', '_')}"
                ).read


class MissingReference(LookupError):
    """The configuration's tracking path has no plain reference."""


def tracking_path(cfg: dict) -> str:
    """The tracking path the port runs for a configuration, from the
    fields it reads itself (`SequenceRunner`'s depth-target backend and
    `optimize_pose`'s switches, over the port's TrackingConfig defaults):
    "general" for backend pallas or reference, else "fulltile" without
    `subtile`, else "kcover" with `kcover` > 0, else "subtile"."""
    from gsplatloc_tpu_torch.opt.tracking import TrackingConfig

    if cfg["backend"] in ("pallas", "reference"):
        return "general"
    tracking = TrackingConfig(**cfg["tracking"])
    if not tracking.subtile:
        return "fulltile"
    return "kcover" if tracking.kcover > 0 else "subtile"


def reference(path: str):
    """The module plainref/paths/<path>.py, the plain reference of the
    tracking path `path`; raises MissingReference, naming the path and the
    file, where there is none."""
    file = HERE / "plainref" / "paths" / f"{path}.py"
    if not file.is_file():
        raise MissingReference(
            f"the {path!r} tracking path has no plain reference: "
            f"{file.relative_to(HERE.parent)} is missing, so no run of it "
            f"can be judged")
    return load(file, f"plainref.paths.{path}")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that no run may hold, compared
    whole (the port's name begins with the JAX package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def clip_frames(c: dict) -> list:
    """[[frame index, ...] per clip]: each clip's consecutive pairs at the
    cell's stride."""
    s = c["stride"]
    return [[f0 + s * j for j in range(n + 1)] for f0, n in c["clips"]]


def ensure_frames(name: str, cfg: dict, log=print) -> Path:
    """The configuration's frame cache, written on the first run in this
    checkout (to a scratch name, renamed when whole)."""
    dst = CACHE / name
    if (dst / "done").exists():
        return dst
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f".{name}-", dir=CACHE))
    t0 = time.perf_counter()
    adapter(cfg).write_cache(tmp, cfg)
    (tmp / "done").write_text(f"{time.perf_counter() - t0:.3f}\n")
    if dst.exists():  # a partial cache of a run that was cut
        shutil.rmtree(dst)
    tmp.rename(dst)
    log(f"[bench] wrote the {name} frames in "
        f"{time.perf_counter() - t0:.1f} s")
    return dst


@dataclass
class ClipRun:
    clip: int
    frames: list
    result: object  # SequenceResult


@dataclass
class Record:
    """What a run measured, for the metric readers."""
    setup_s: float = 0.0
    window_s: float = 0.0
    passes: int = 0
    pairs: int = 0
    peak_bytes: int = 0
    stage_s: dict = field(default_factory=dict)
    steps: list = field(default_factory=list)
    selects: list = field(default_factory=list)
    trace: dict | None = None  # tracer.py's readings of a traced run


class Window:
    """The cell's clips as folders under `tmp`, and the runs over them."""

    def __init__(self, cell_: dict, cfg: dict, cache: Path, tmp: Path,
                 device: str):
        from gsplatloc_tpu_torch.opt.tracking import TrackingConfig

        self.cell, self.cfg, self.tmp, self.device = cell_, cfg, tmp, device
        self.tracking = TrackingConfig(**cfg["tracking"])
        self.path = tracking_path(cfg)
        ce = cfg.get("crop_edge", 0)
        self.image_wh = (cfg["width"] - 2 * ce, cfg["height"] - 2 * ce)
        mod = adapter(cfg)
        self.clips = []  # (frames, folder, dataset kwargs)
        for i, frames in enumerate(clip_frames(cell_)):
            folder = tmp / f"clip{i}"
            kwargs = mod.make_clip(cache, cfg, frames, folder)
            self.clips.append((frames, folder, kwargs))
        self._n = 0

    def run_clip(self, i: int, max_pairs: int | None = None) -> ClipRun:
        from gsplatloc_tpu_torch.tracking.runner import SequenceRunner

        frames, _folder, kwargs = self.clips[i]
        self._n += 1
        runner = SequenceRunner(
            normalize=True, config=self.tracking,
            backend=self.cfg["backend"],
            run_dir=self.tmp / "runs" / f"{self._n:04d}",
            max_pairs=max_pairs or len(frames) - 1,
            knn_method=self.cfg["knn_method"], device=self.device, **kwargs)
        res = runner.train(progress=False, prefetch=True)
        return ClipRun(i, frames, res)

    def measure(self, order: list, seconds: float, record: Record,
                sync) -> list:
        """ceil(seconds / pass_s) whole passes over `order`; fills the
        record's window fields and returns the clip runs."""
        runs = []
        t0 = time.perf_counter()
        for _ in range(max(1, math.ceil(seconds / self.cell["pass_s"]))):
            for i in order:
                runs.append(self.run_clip(i))
            record.passes += 1
        sync()
        record.window_s = time.perf_counter() - t0
        for r in runs:
            res = r.result
            record.pairs += len(res.poses_est)
            record.steps += list(res.steps)
            record.selects += list(res.selects)
            for k, v in res.stage_s.items():
                record.stage_s[k] = record.stage_s.get(k, 0.0) + v
        return runs


def seed_plan(seed: int, cell_: dict) -> tuple:
    """(clip order, [(clip, pair)] to check) drawn from the seed."""
    rng = np.random.default_rng(seed)
    n = len(cell_["clips"])
    order = [int(i) for i in rng.permutation(n)]
    pairs = [(c, j) for c, (_f0, n_pairs) in enumerate(cell_["clips"])
             for j in range(n_pairs)]
    pick = rng.choice(len(pairs), size=cell_["checked_pairs"], replace=False)
    return order, [pairs[int(k)] for k in sorted(pick)]


def read_metrics(bench: dict, trace: bool, record: Record) -> dict:
    """{name: {"value", "unit"}} of every metric a reader finds: the
    end-to-end ones with --trace 0, the per-layer ones with --trace 1."""
    out = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        value = reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
