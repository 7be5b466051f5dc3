#!/usr/bin/env python3
"""Profiler split of the sub-tile pose chain K5b (`subtile_chain`) and the
full-tile probe K7c (`fused_probe`) at chip_smoke.py's phase-3 shapes, on
one NVIDIA GPU.

    python3 tools/profile_split.py [TREE ...]

Each TREE (default: this checkout) is a checkout of the repository whose
`gsplatloc_tpu_torch` and `chip_smoke.py` are profiled, each in its own
process, one after the other, so that two versions can be compared on one
card in one command (for example parent, change, change, parent).

For each wrapper call it prints: the mean time per call by CUDA events
over back-to-back calls (what chip_smoke.py reports), the host time per
call, and from a torch.profiler trace (CUDA activities) the device
kernels of one call in launch order with their mean durations, the mean
idle gaps between consecutive kernels of a call, and the mean period from
one call's first kernel to the next call's. Also each kernel's registers
and spills from the build's `-Xptxas -v`. For the chain also its distance
from a float64 replay of the chain and from the float64 sum of its f32
per-slot partials (the reduction's own error), each relative to the
largest scalar. The last line of each tree's output is one JSON object
with the same figures.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
N_CHAIN = 50
N_PROBE = 20
# kernel names in the build log (older and newer trees)
PTXAS_NAMES = ("subtile_chain_kernel", "sum12_kernel", "fused_probe_kernel",
               "fused_fwd_kernel", "fused_walk_kernelILb0E",
               "fused_walk_kernelILb1E")


def _short(name):
    """A kernel's name without namespace, template arguments and
    parameters; torch's fill kernel (torch.zeros) as `fill`."""
    if "FillFunctor" in name:
        return "fill"
    found = re.findall(r"(\w+_kernel\w*(?:<\w+>)?)", name.split("(")[0])
    return found[-1] if found else name[:60]


def _trace_kernels(fn, n):
    """The device kernels of n back-to-back calls of fn, from a
    torch.profiler trace: [(name, start_us, dur_us)] in start order."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    ks = [(_short(e["name"]), float(e["ts"]), float(e["dur"]))
          for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
    return sorted(ks, key=lambda k: k[1])


def _split(fn, n):
    """Per-call kernels, gaps and period from the trace of n calls."""
    ks = _trace_kernels(fn, n)
    if not ks or len(ks) % n:
        return {"kernels_traced": len(ks), "calls": n,
                "note": "no per-call split: the trace holds "
                        f"{len(ks)} kernels for {n} calls"}
    per = len(ks) // n
    calls = [ks[i * per:(i + 1) * per] for i in range(n)]
    names = [k[0] for k in calls[0]]
    if any([k[0] for k in c] != names for c in calls):
        return {"kernels_traced": len(ks), "calls": n,
                "note": "calls launch different kernel sequences"}
    dur = [sum(c[j][2] for c in calls) / n / 1e3 for j in range(per)]
    gaps = [sum(c[j + 1][1] - (c[j][1] + c[j][2]) for c in calls) / n / 1e3
            for j in range(per - 1)]
    period = ((calls[-1][0][1] - calls[0][0][1]) / (n - 1) / 1e3
              if n > 1 else None)
    return {"kernels": [{"name": nm, "ms": d} for nm, d in zip(names, dur)],
            "gaps_ms": gaps, "kernel_ms": sum(dur),
            "first_to_last_ms": sum(dur) + sum(gaps),
            "period_ms": period}


def _host_ms(fn, n):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def profile_tree():
    """Run in a process whose sys.path starts with the tree to profile."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from gsplatloc_tpu_torch import kernels
    from gsplatloc_tpu_torch.ops import fused_subtile as fs
    from gsplatloc_tpu_torch.ops import fused_tracking as ft
    from gsplatloc_tpu_torch.ops.binning import TILE_H, TILE_W
    from gsplatloc_tpu_torch.ops.lie import invert_se3
    from scipy.spatial.transform import Rotation

    if not torch.cuda.is_available():
        raise RuntimeError("profile_split.py needs a CUDA device")
    dev = torch.device("cuda")
    H, W, NEAR, FAR = cs.H, cs.W, cs.NEAR, cs.FAR
    out = {"tree": str(Path(cs.__file__).resolve().parent),
           "device": cs.smi_line()}
    print(f"[profile] tree {out['tree']}; {out['device']}", flush=True)
    kernels.load()
    out["ptxas"] = {k: dict(zip(("regs", "spill_stores", "spill_loads"),
                                cs.ptxas_usage(k))) for k in PTXAS_NAMES}
    n_ty, n_tx = -(-H // TILE_H), -(-W // TILE_W)
    pair = cs.make_pair()
    K = torch.as_tensor(pair["K"], device=dev)

    # K5b: as chip_smoke.py's check_subtile_bwd builds its inputs
    scene = cs.frame_scene(pair, "tar", dev)
    vm = invert_se3(torch.as_tensor(pair["tar_c2w"], device=dev))
    near_c2w = np.eye(4, dtype=np.float32)
    near_c2w[:3, :3] = Rotation.from_euler(
        "xyz", [0.06, -0.04, 0.03], degrees=True).as_matrix()
    near_c2w[:3, 3] = [0.005, -0.004, 0.006]
    cam_s = cs.cam_vector(invert_se3(torch.as_tensor(near_c2w, device=dev)),
                          K, W, H).contiguous()
    slot, meta, _ = fs.build_subtile_slot_buffer(scene, vm, K, W, H, NEAR,
                                                 FAR)
    p8 = fs.project8(slot, cam_s, NEAR, FAR)
    fwd, cd = fs.subtile_fwd(p8, meta, n_ty, n_tx)
    rng = np.random.default_rng(cs.SEED)
    g = torch.as_tensor(rng.standard_normal((2, fwd.shape[1])).astype(
        np.float32), device=dev)
    mom = fs.subtile_bwd(p8, torch.cat([fwd, g]).contiguous(), meta, n_ty,
                         n_tx, cd)
    del scene, p8, fwd, g

    def chain():
        return fs.subtile_chain(slot, mom, cam_s, meta, n_tx)

    d = chain()
    # distance from the chain replayed in float64 on the same f32 inputs,
    # relative to the replay's largest scalar
    d64 = fs._chain_xla(slot.double(), mom.double(), cam_s.double(), meta,
                        n_tx)
    f64_rel = float((d.double() - d64).abs().max() / d64.abs().max())
    # the reduction's own error: distance from the float64 sum of the f32
    # per-slot partials (the plain version's arithmetic) of the slots with
    # a moment in the walked range
    lo, hi = int(meta[1]), int(meta[-1])
    mv = mom[:, lo:hi]
    ty = torch.floor(mv[7] * (1.0 / fs.ENC_Y))
    maps = ft._pose_chain(
        ft._project_slots(slot[:, lo:hi], cam_s), *(mv[r] for r in range(7)),
        (mv[7] - fs.ENC_Y * ty) * fs.SUB_W, ty * fs.SUB_H, cam_s[0],
        cam_s[1], reduce=False)
    keep = (mv[:7] != 0).any(dim=0)
    exact = torch.stack([torch.where(keep, m.reshape(-1), 0.0).double().sum()
                         for m in maps])
    sum_rel = float((d.flatten()[:12].double() - exact).abs().max()
                    / exact.abs().max())
    del maps
    out["subtile_chain"] = dict(
        m_pad=slot.shape[1], walked_range=int(meta[-1] - meta[1]),
        d=[float(x) for x in d.flatten()[:12].tolist()],
        d64=[float(x) for x in d64.flatten()[:12].tolist()],
        f64_rel_err=f64_rel, sum_rel_err=sum_rel,
        event_ms=cs.time_ms(chain, N_CHAIN), host_ms=_host_ms(chain, N_CHAIN),
        **_split(chain, N_CHAIN))
    del slot, mom, meta
    torch.cuda.empty_cache()

    # K7c: as chip_smoke.py's check_fused_tracking builds its inputs
    scene = cs.frame_scene(pair, "tar", dev)
    vm = invert_se3(torch.as_tensor(pair["src_c2w"], device=dev))
    slot, meta, b = ft.build_slot_buffer(scene, vm, K, W, H, NEAR, FAR)
    del scene
    cam = cs.cam_vector(vm, K, W, H).contiguous()

    def probe():
        return ft.fused_probe(slot, meta, cam, b.n_tiles_y, b.n_tiles_x,
                              NEAR, FAR)

    c, pcd = probe()
    out["fused_probe"] = dict(
        m_pad=slot.shape[1], kept=int((c > 0).sum()),
        chunks=int(pcd.sum()),
        event_ms=cs.time_ms(probe, N_PROBE), host_ms=_host_ms(probe, N_PROBE),
        **_split(probe, N_PROBE))
    for k in ("subtile_chain", "fused_probe"):
        print(f"[profile] {k}: {json.dumps(out[k])}", flush=True)
    print(f"[profile] ptxas {json.dumps(out['ptxas'])}", flush=True)
    return out


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--one":
        tree = Path(sys.argv[2]).resolve()
        os.chdir(tree)
        sys.path.insert(0, str(tree))
        print(json.dumps(profile_tree()), flush=True)
        return
    trees = [Path(t).resolve() for t in sys.argv[1:]] or [REPO]
    failed = 0
    for tree in trees:
        p = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--one", str(tree)])
        failed += p.returncode != 0
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
