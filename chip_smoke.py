#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing carries on on the CPU):

  1. device  — card name and power limit (nvidia-smi), torch/CUDA versions.
  2. build   — first use compiles gsplatloc_tpu_torch/csrc/*.cu with nvcc.
  3. kernels — every hand-written kernel against its plain PyTorch version
               on the card, at the shapes the main path gives it
               (1200x680, 816,000 splats, K=16), with CUDA-event timings
               and the least time the card could take for the same work.
  4. main    — one displaced synthetic RGB-D frame pair prepared
               (_assemble_pair) and pose-tracked (optimize_pose, default
               K-cover configuration, max_steps=300), run twice; launch
               counters are zeroed just before each run and read just after.
  5. subtile — the same pair tracked through the sub-tile path
               (TrackingConfig(kcover=0), max_steps=300), run twice, with
               its own zeroed and read launch counters.
  6. track   — the entry point a user types, in process:
               `cli track --dataset Synthetic` on 4 frames at 1200x680 with
               exact kNN, once with the default --kcover 16, once with
               --kcover 0, and the --kcover 16 run again with --no-prefetch
               (its per-pair errors must equal the prefetched run's bit for
               bit); each run writes res.json into a temporary directory.

The line before the last is a JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}. Exit code 0 only if every phase passed.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import gsplatloc_tpu_torch  # noqa: F401  (sets the TF32 flags)
from gsplatloc_tpu_torch import kernels
from gsplatloc_tpu_torch.data.parser import _assemble_pair
from gsplatloc_tpu_torch.data.synthetic import box_room_frame
from gsplatloc_tpu_torch.models.gaussians import scene_from_point_cloud
from gsplatloc_tpu_torch.ops import fused_subtile as fs
from gsplatloc_tpu_torch.ops import kcover as kc
from gsplatloc_tpu_torch.ops.binning import TILE_H, TILE_W
from gsplatloc_tpu_torch.ops.camera import depth_to_points
from gsplatloc_tpu_torch.ops.fused_tracking import cam_vector
from gsplatloc_tpu_torch.ops.lie import invert_se3, transform_points
from gsplatloc_tpu_torch.opt.tracking import TrackingConfig, optimize_pose

H, W = 680, 1200
FX = 600.0
K_COVER = 16
NEAR, FAR = 1e-2, 1e10
SEED = 0

# published peaks of one H100 SXM (dense, full power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# floating-point operations per unit of work, counted from csrc/project.cuh
# (one expf counted as 8)
OPS_PROJECT = 67  # project_parts, per slot / record
OPS_COEFF = 22  # coeff_mat, per staged slot
OPS_ALPHA_DIRECT = 32  # K-cover step: sigma at the pixel + compositing
OPS_PAIR_SELECT = 24  # select: polynomial sigma + gates + T update
OPS_PAIR_WALK = 29  # sub-tile walk: polynomial sigma + compositing
OPS_CHAIN = 236  # pose_chain, per contributing record
# sub-tile backward, per live (slot, pixel) pair of a walked chunk:
# sub_alpha 23 (sigma 10, negate 1, expf 8, opacity 1, clamp 1, gates 2) +
# the adjoint 22 (1-alpha, T*, live, w, phi 2, run 2, suffix, fmax, divide,
# suffix*inv, T*phi, subtract, gates 4, d_sigma 2, w*g_d) + the moment
# sums 6 (row sum of d_sigma, x*d_sigma 2, x^2*d_sigma 2, w*g_d)
OPS_PAIR_BWD = 51
OPS_DECODE = 6  # sub-tile chain: origin decode from moment row 7, per slot

TOL_FWD = 1e-5  # abs, depth_acc / alpha (f32 sum order over K)
TOL_BWD_REL = 1e-4  # rel, 12 pose scalars (f32 sum order over ~14 M terms)
# rel to each row's largest magnitude: the sub-tile moments of d_sigma
# (per-pixel values equal, summed over 256 pixels in another order)
TOL_MOM_REL = 1e-5


def log(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stdout}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n, warm=2):
    """Mean milliseconds of fn() over n launches, CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def bound(bytes_moved, ops):
    t_b = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_o = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def make_pair():
    """tar at identity, src displaced by ~2 cm and ~1 degree."""
    from scipy.spatial.transform import Rotation

    K = np.array([[FX, 0, W / 2 - 0.5], [0, FX, H / 2 - 0.5], [0, 0, 1]],
                 np.float32)
    tar = np.eye(4, dtype=np.float32)
    src = np.eye(4, dtype=np.float32)
    src[:3, :3] = Rotation.from_euler(
        "xyz", [0.6, -0.5, 0.4], degrees=True).as_matrix()
    src[:3, 3] = [0.012, -0.008, 0.014]
    tar_rgb, tar_depth = box_room_frame(tar, K, H, W)
    src_rgb, src_depth = box_room_frame(src, K, H, W)
    return dict(K=K, tar_c2w=tar, src_c2w=src,
                tar_rgb=(tar_rgb * 255.0).astype(np.float32),
                tar_depth=tar_depth,
                src_rgb=(src_rgb * 255.0).astype(np.float32),
                src_depth=src_depth)


def pose_errors(est_c2w, true_c2w):
    est = est_c2w.detach().double().cpu().numpy()
    true = true_c2w.detach().double().cpu().numpy()
    e_t = float(np.linalg.norm(est[:3, 3] - true[:3, 3]))
    cos = (np.trace(est[:3, :3] @ true[:3, :3].T) - 1.0) / 2.0
    e_r = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
    return e_t, e_r


def kernel_entry(name, source, replaces, err, ms, plain_ms, bnd, **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                max_err=err, kernel_ms=ms, **extra)


def check_kernels(pair, dev):
    """Phase 3: each kernel vs its plain version at the main path's shapes."""
    entries = []
    n_ty, n_tx = -(-H // TILE_H), -(-W // TILE_W)
    K = torch.as_tensor(pair["K"], device=dev)
    tar_c2w = torch.as_tensor(pair["tar_c2w"], device=dev)

    # --- K4: the depth-target render of the src cloud from the tar view
    src_pts = transform_points(
        tar_c2w, depth_to_points(torch.as_tensor(pair["src_depth"], device=dev), K))
    src_rgb = torch.as_tensor(pair["src_rgb"], device=dev).reshape(-1, 3) / 255.0
    gt_scene = scene_from_point_cloud(src_pts, src_rgb, grid_shape=(H, W),
                                      device=dev)
    vm = invert_se3(tar_c2w)
    slot_p, meta_p, _ = fs.build_subtile_slot_buffer(
        gt_scene, vm, K, W, H, NEAR, FAR)
    cam = cam_vector(vm, K, W, H).contiguous()
    m_pad = slot_p.shape[1]
    p8_k = fs.project8(slot_p, cam, NEAR, FAR)
    p8_p = fs._project8(slot_p, cam, NEAR, FAR)
    torch.cuda.synchronize()
    err = float((p8_k - p8_p).abs().max())
    log(f"[kernels] project8: M_pad={m_pad} max_abs_err={err:.3e} "
        f"bit_equal={torch.equal(p8_k, p8_p)}")
    if not err <= TOL_FWD:
        raise RuntimeError(f"project8 disagrees with its plain version: {err}")
    ms = time_ms(lambda: fs.project8(slot_p, cam, NEAR, FAR), 50)
    pms = time_ms(lambda: fs._project8(slot_p, cam, NEAR, FAR), 5, warm=1)
    entries.append(kernel_entry(
        "project8", "gsplatloc_tpu_torch/csrc/subtile_fwd.cu",
        "gsplatloc_tpu/ops/fused_subtile.py:655", err, ms, pms,
        bound((5 + 8) * 4 * m_pad, (OPS_PROJECT + 3) * m_pad)))

    out_k, cd_k = fs.subtile_fwd(p8_k, meta_p, n_ty, n_tx)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p, cd_p = fs._subtile_fwd_plain(p8_p, meta_p, n_ty, n_tx, stats=stats)
    torch.cuda.synchronize()
    pms = (time.perf_counter() - t0) * 1e3
    err = float((out_k - out_p).abs().max())
    cd_equal = torch.equal(cd_k, cd_p)
    log(f"[kernels] subtile_fwd: M_out={out_k.shape[1]} max_abs_err={err:.3e} "
        f"bit_equal={torch.equal(out_k, out_p)} chunks_done_equal={cd_equal} "
        f"chunks_walked={int(cd_k.sum())} (full size, no crop)")
    if not err <= TOL_FWD or not cd_equal:
        raise RuntimeError("subtile_fwd disagrees with its plain version: "
                           f"err={err} chunks_done_equal={cd_equal}")
    ms = time_ms(lambda: fs.subtile_fwd(p8_k, meta_p, n_ty, n_tx), 20)
    walked = int(cd_k.sum()) * fs.CHUNK
    entries.append(kernel_entry(
        "subtile_fwd", "gsplatloc_tpu_torch/csrc/subtile_fwd.cu",
        "gsplatloc_tpu/ops/fused_subtile.py:737", err, ms, pms,
        bound(walked * 8 * 4 + 2 * 4 * out_k.shape[1] + 4 * (cd_k.numel() + meta_p.numel()),
              stats["pairs"] * OPS_PAIR_WALK + walked * OPS_COEFF)))
    del slot_p, p8_k, p8_p, out_p, gt_scene

    # --- K3: select at the init pose of the tracking scene
    tar_pts = transform_points(
        tar_c2w, depth_to_points(torch.as_tensor(pair["tar_depth"], device=dev), K))
    tar_rgb = torch.as_tensor(pair["tar_rgb"], device=dev).reshape(-1, 3) / 255.0
    scene = scene_from_point_cloud(tar_pts, tar_rgb, grid_shape=(H, W),
                                   device=dev)
    slot3d, meta, ovf = kc.build_kcover_slot_buffer(
        scene, vm, K, W, H, NEAR, FAR)
    if bool(ovf):
        raise RuntimeError("slot budget overflow in the kernel check")
    kb_k = kc.select_kcover_records(slot3d, meta, cam, n_ty, n_tx, K_COVER,
                                    NEAR, FAR)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kb_p = kc._select_records_plain(slot3d, meta, cam, n_ty, n_tx, K_COVER,
                                    NEAR, FAR, stats=stats)
    torch.cuda.synchronize()
    pms = (time.perf_counter() - t0) * 1e3
    err = float((kb_k - kb_p).abs().max())
    r_k = kc._kcover_step_fwd_plain(kb_k, cam, n_ty, n_tx, NEAR, FAR)
    r_p = kc._kcover_step_fwd_plain(kb_p, cam, n_ty, n_tx, NEAR, FAR)
    r_err = float((r_k - r_p).abs().max())
    log(f"[kernels] kcover_select_records: B_pad={slot3d.shape[1]} "
        f"max_abs_err={err:.3e} bit_equal={torch.equal(kb_k, kb_p)} "
        f"render_err={r_err:.3e} (full size, no crop)")
    if err != 0.0 or not r_err <= TOL_FWD:
        raise RuntimeError("kcover_select_records disagrees with its plain "
                           f"version: records {err}, render {r_err}")
    ms = time_ms(lambda: kc.select_kcover_records(
        slot3d, meta, cam, n_ty, n_tx, K_COVER, NEAR, FAR), 20)
    entries.append(kernel_entry(
        "kcover_select_records", "gsplatloc_tpu_torch/csrc/kcover_select.cu",
        "gsplatloc_tpu/ops/kcover.py:511", err, ms, pms,
        bound(stats["slots"] * 5 * 4 + kb_k.numel() * 4 + meta.numel() * 4,
              stats["pairs"] * OPS_PAIR_SELECT
              + stats["slots"] * (OPS_PROJECT + OPS_COEFF)),
        render_err=r_err))
    del kb_p, r_k, r_p, slot3d

    # --- K1 / K2: the step render at a pose about a pixel away from the
    # selection pose (the staleness the select gate allows), so that every
    # gradient path is live
    from scipy.spatial.transform import Rotation

    near_c2w = np.eye(4, dtype=np.float32)
    near_c2w[:3, :3] = Rotation.from_euler(
        "xyz", [0.06, -0.04, 0.03], degrees=True).as_matrix()
    near_c2w[:3, 3] = [0.005, -0.004, 0.006]
    cam_s = cam_vector(invert_se3(torch.as_tensor(near_c2w, device=dev)),
                       K, W, H).contiguous()
    m_out = kb_k.shape[2]
    f_k = kc.kcover_step_fwd(kb_k, cam_s, n_ty, n_tx, NEAR, FAR)
    f_p = kc._kcover_step_fwd_plain(kb_k, cam_s, n_ty, n_tx, NEAR, FAR)
    err = float((f_k - f_p).abs().max())
    pieces = kc._kcover_fwd_pieces(kb_k, cam_s, n_ty, n_tx, NEAR, FAR)
    needed = int((pieces[5] > kc.T_EPS).sum())  # records read until dead
    chained = int((pieces[3] & (pieces[5] > kc.T_EPS)).sum())
    del pieces
    log(f"[kernels] kcover_step_fwd: max_abs_err={err:.3e} "
        f"records_needed={needed} of {K_COVER * m_out}")
    coverage = float(f_p[1].mean())
    if not err <= TOL_FWD or not coverage > 0.2:
        raise RuntimeError(f"kcover_step_fwd disagrees: err {err}, "
                           f"mean alpha {coverage}")
    ms = time_ms(lambda: kc.kcover_step_fwd(kb_k, cam_s, n_ty, n_tx, NEAR, FAR), 50)
    pms = time_ms(lambda: kc._kcover_step_fwd_plain(
        kb_k, cam_s, n_ty, n_tx, NEAR, FAR), 3, warm=1)
    entries.append(kernel_entry(
        "kcover_step_fwd", "gsplatloc_tpu_torch/csrc/kcover_step.cu",
        "gsplatloc_tpu/ops/kcover.py:940", err, ms, pms,
        bound(needed * 5 * 4 + 2 * 4 * m_out,
              needed * (OPS_PROJECT + OPS_ALPHA_DIRECT)),
        records_needed=needed))

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    g_d = torch.randn(m_out, generator=gen).to(dev)
    g_a = torch.randn(m_out, generator=gen).to(dev)
    b_k = kc.kcover_step_bwd(kb_k, cam_s, n_ty, n_tx, NEAR, FAR, g_d, g_a)
    b_k2 = kc.kcover_step_bwd(kb_k, cam_s, n_ty, n_tx, NEAR, FAR, g_d, g_a)
    b_p = kc._kcover_step_bwd_plain(kb_k, cam_s, n_ty, n_tx, NEAR, FAR, g_d, g_a)
    torch.cuda.synchronize()
    err = float((b_k - b_p).abs().max())
    rel = err / float(b_p.abs().max())  # relative to the largest scalar
    rel_n = float((b_k - b_p).norm() / b_p.norm())
    repeat = torch.equal(b_k, b_k2)
    log(f"[kernels] kcover_step_bwd: max_abs_err={err:.3e} "
        f"max_rel_err={rel:.3e} rel_norm_err={rel_n:.3e} "
        f"bitwise_repeatable={repeat}")
    if not rel <= TOL_BWD_REL or not repeat:
        raise RuntimeError(f"kcover_step_bwd disagrees: rel {rel}, "
                           f"repeatable {repeat}")
    ms = time_ms(lambda: kc.kcover_step_bwd(
        kb_k, cam_s, n_ty, n_tx, NEAR, FAR, g_d, g_a), 50)
    pms = time_ms(lambda: kc._kcover_step_bwd_plain(
        kb_k, cam_s, n_ty, n_tx, NEAR, FAR, g_d, g_a), 3, warm=1)
    entries.append(kernel_entry(
        "kcover_step_bwd", "gsplatloc_tpu_torch/csrc/kcover_step.cu",
        "gsplatloc_tpu/ops/kcover.py:964", err, ms, pms,
        bound(needed * 5 * 4 + 2 * 4 * m_out + 48,
              needed * 2 * (OPS_PROJECT + OPS_ALPHA_DIRECT)
              + chained * OPS_CHAIN),
        max_rel_err=rel))
    del kb_k
    entries += check_subtile_bwd(scene, vm, cam_s, K, dev, n_ty, n_tx)
    return entries


def check_subtile_bwd(scene, vm, cam_s, K, dev, n_ty, n_tx):
    """K5a / K5b at the kcover=0 path's shapes: the tracking scene's
    sub-tile slot buffer built at the init pose, rendered at a pose about a
    pixel away, with cotangents made from a numpy seed."""
    entries = []
    slot, meta, _ = fs.build_subtile_slot_buffer(scene, vm, K, W, H, NEAR, FAR)
    m_pad = slot.shape[1]
    p8 = fs.project8(slot, cam_s, NEAR, FAR)
    out, cd = fs.subtile_fwd(p8, meta, n_ty, n_tx)
    m_out = out.shape[1]
    rng = np.random.default_rng(SEED)
    g = torch.as_tensor(rng.standard_normal((2, m_out)).astype(np.float32),
                        device=dev)
    sin = torch.cat([out, g]).contiguous()
    mom_k = fs.subtile_bwd(p8, sin, meta, n_ty, n_tx)
    mom_k2 = fs.subtile_bwd(p8, sin, meta, n_ty, n_tx)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mom_p = fs._subtile_bwd_plain(p8, sin, meta, n_ty, n_tx, stats=stats)
    torch.cuda.synchronize()
    pms = (time.perf_counter() - t0) * 1e3
    rel_rows = [float((mom_k[r] - mom_p[r]).abs().max()
                      / mom_p[r].abs().max().clamp_min(1e-30))
                for r in range(7)]
    err = float((mom_k[:7] - mom_p[:7]).abs().max())
    row7 = torch.equal(mom_k[7], mom_p[7])
    zero_p = (mom_p == 0).all(dim=0)
    zeros_equal = torch.equal(zero_p, (mom_k == 0).all(dim=0))
    repeat = torch.equal(mom_k, mom_k2)
    walked = int(cd.sum()) * fs.CHUNK
    log(f"[kernels] subtile_bwd: M_pad={m_pad} walked_slots={walked} "
        f"max_abs_err={err:.3e} max_rel_err_by_row="
        f"{[float(f'{x:.3e}') for x in rel_rows]} row7_equal={row7} "
        f"zero_fill_equal={zeros_equal} bitwise_repeatable={repeat} "
        f"(full size, no crop)")
    if not (max(rel_rows) <= TOL_MOM_REL and row7 and zeros_equal and repeat):
        raise RuntimeError("subtile_bwd disagrees with its plain version: "
                           f"rows {rel_rows}, row7 {row7}, zero-fill "
                           f"{zeros_equal}, repeatable {repeat}")
    ms = time_ms(lambda: fs.subtile_bwd(p8, sin, meta, n_ty, n_tx), 20)
    entries.append(kernel_entry(
        "subtile_bwd", "gsplatloc_tpu_torch/csrc/subtile_bwd.cu",
        "gsplatloc_tpu/ops/fused_subtile.py:782", err, ms, pms,
        bound(walked * 8 * 4 + 4 * 4 * m_out + 8 * 4 * m_pad
              + 4 * meta.numel(),
              stats["pairs"] * OPS_PAIR_BWD + walked * OPS_COEFF),
        max_rel_err=max(rel_rows), walked_slots=walked,
        pairs=stats["pairs"]))
    del mom_k2, mom_p

    d_k = fs.subtile_chain(slot, mom_k, cam_s, meta, n_tx)
    d_k2 = fs.subtile_chain(slot, mom_k, cam_s, meta, n_tx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_p = fs._chain_xla(slot, mom_k, cam_s, meta, n_tx)
    torch.cuda.synchronize()
    pms = (time.perf_counter() - t0) * 1e3
    err = float((d_k - d_p).abs().max())
    rel = err / float(d_p.abs().max())
    repeat = torch.equal(d_k, d_k2)
    lo, hi = int(meta[1]), int(meta[-1])
    in_range = hi - lo
    nonzero = int((mom_k[:7, lo:hi] != 0).any(dim=0).sum())
    log(f"[kernels] subtile_chain: slots_in_range={in_range} "
        f"slots_with_moments={nonzero} max_abs_err={err:.3e} "
        f"max_rel_err={rel:.3e} bitwise_repeatable={repeat}")
    if not rel <= TOL_BWD_REL or not repeat:
        raise RuntimeError(f"subtile_chain disagrees: rel {rel}, "
                           f"repeatable {repeat}")
    ms = time_ms(lambda: fs.subtile_chain(slot, mom_k, cam_s, meta, n_tx), 50)
    entries.append(kernel_entry(
        "subtile_chain", "gsplatloc_tpu_torch/csrc/subtile_bwd.cu",
        "gsplatloc_tpu/ops/fused_subtile.py:708", err, ms, pms,
        bound(7 * 4 * in_range + (1 + 5) * 4 * nonzero + 4 * meta.numel()
              + 4 * 16,
              nonzero * (OPS_DECODE + OPS_PROJECT + OPS_CHAIN)),
        max_rel_err=rel, slots_with_moments=nonzero))
    return entries


def run_main_path(pair, dev, config):
    """Phases 4 and 5: prepare -> scene -> optimize, through the entry
    points."""
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = _assemble_pair(
        pair["tar_rgb"], pair["tar_depth"], pair["tar_c2w"],
        pair["src_rgb"], pair["src_depth"], pair["src_c2w"], pair["K"],
        height=H, width=W, normalize=True, backend="subtile")
    scene = scene_from_point_cloud(out["tar_points"], out["colors"],
                                   grid_shape=(H, W))
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    res = optimize_pose(scene, out["tar_c2w"], out["src_depth"], pair["K"],
                        W, H, config=config, backend="fused")
    e1.record()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    opt_ms = e0.elapsed_time(e1)
    return dict(out=out, res=res, counts=counts, t_prep=t_prep,
                opt_ms=opt_ms, peak=torch.cuda.max_memory_allocated())


def tracked_pair(pair, dev, config, tag):
    """Phases 4/5: the pair tracked twice with `config`; checks recovery
    (eT and eR down 10x), finite results, the second run bit-equal to the
    first. Returns the first run's launch counts."""
    runs = [run_main_path(pair, dev, config) for _ in range(2)]
    r = runs[0]
    res, out = r["res"], r["out"]
    e_t0, e_r0 = pose_errors(out["tar_c2w"], out["src_c2w"])
    e_t, e_r = pose_errors(res.best_pose.to_c2w(), out["src_c2w"])
    counts = r["counts"]
    step_kernel = "kcover_step_fwd" if config.kcover > 0 else "subtile_bwd"
    launched = counts[step_kernel]
    log(f"[{tag}] config kcover={config.kcover} max_steps={config.max_steps}")
    log(f"[{tag}] init  eT {e_t0 * 100:.4f} cm  eR {e_r0:.4f} deg")
    log(f"[{tag}] best  eT {e_t * 100:.4f} cm  eR {e_r:.4f} deg  "
        f"best_loss {float(res.best_loss):.6e}")
    log(f"[{tag}] steps_run {res.steps_run} rebuilds {res.rebuilds} "
        f"selects {res.selects} slot_overflow {res.slot_overflow}")
    log(f"[{tag}] prepare {r['t_prep'] * 1e3:.1f} ms; optimize "
        f"{r['opt_ms']:.1f} ms = {r['opt_ms'] / max(launched, 1):.3f} ms per "
        f"launched step ({launched} launched, {res.steps_run} run); second "
        f"run optimize {runs[1]['opt_ms']:.1f} ms")
    log(f"[{tag}] launches {json.dumps(counts)}")
    log(f"[{tag}] max_memory_allocated {r['peak'] / 2**20:.0f} MiB")

    if res.slot_overflow:
        raise RuntimeError(f"slot_overflow on the {tag} pair")
    if launched < res.steps_run:
        raise RuntimeError("fewer step launches than steps run")
    if not (e_t * 10 <= e_t0 and e_r * 10 <= e_r0):
        raise RuntimeError("pose error not reduced 10x: "
                           f"eT {e_t0}->{e_t}, eR {e_r0}->{e_r}")
    for t in (res.best_pose.quat, res.best_pose.trans, res.best_loss,
              out["src_depth"]):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError("non-finite value in the result")
    if tuple(out["src_depth"].shape) != (H, W):
        raise RuntimeError("depth target has the wrong shape")
    res2 = runs[1]["res"]
    same = (torch.equal(res.best_pose.quat, res2.best_pose.quat)
            and torch.equal(res.best_pose.trans, res2.best_pose.trans)
            and torch.equal(res.best_loss, res2.best_loss)
            and res.steps_run == res2.steps_run
            and res.rebuilds == res2.rebuilds
            and runs[1]["counts"] == counts)
    log(f"[{tag}] second run bit-equal to the first: {same}")
    if not same:
        raise RuntimeError("second run differs from the first")
    return counts


def _read_run(run_dir):
    """(per-pair records, final summary record, config) of one track run."""
    recs = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    pairs = [r for r in recs if "eT" in r]
    summary = [r for r in recs if "ate_rmse" in r][-1]
    cfg = json.loads((run_dir / "config.json").read_text())
    return pairs, summary, cfg


def run_track_cli():
    """Phase 6: `cli track` on a generated 4-frame Synthetic sequence at
    1200x680, in process, with the kernels' launch counters zeroed before
    and read after each run."""
    from gsplatloc_tpu_torch import cli

    n_frames, n_iters = 4, 300
    root = Path(tempfile.mkdtemp(prefix="gsl_track_"))
    try:
        results = {}
        for tag, extra, want in (
                ("kcover16", [], ("kcover_step_fwd", "kcover_step_bwd",
                                  "kcover_select_records", "project8",
                                  "subtile_fwd")),
                ("kcover0", ["--kcover", "0"], ("project8", "subtile_fwd",
                                                "subtile_bwd",
                                                "subtile_chain")),
                ("kcover16_serial", ["--no-prefetch"], ())):
            run_dir = root / tag
            argv = ["track", "--dataset", "Synthetic", "--frames",
                    str(n_frames), "--height", str(H), "--width", str(W),
                    "--num-iters", str(n_iters), "--run-dir", str(run_dir),
                    "--quiet", *extra]
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            res = json.loads((run_dir / "res.json").read_text())
            pairs, summary, cfg = _read_run(run_dir / "synthetic")
            e_t = [p["eT"] for p in pairs]
            e_r = [p["eR"] for p in pairs]
            log(f"[track:{tag}] argv {' '.join(argv[1:])}")
            log(f"[track:{tag}] knn_method {cfg['knn_method']} pairs "
                f"{len(pairs)} ATE-RMSE {summary['ate_rmse'] * 100:.5f} cm "
                f"AAE-RMSE {summary['aae_rmse']:.5f} deg; eT/pair [cm] "
                f"{[round(x * 100, 5) for x in e_t]} eR/pair [deg] "
                f"{[round(x, 5) for x in e_r]}")
            log(f"[track:{tag}] steps {[int(p['steps']) for p in pairs]} "
                f"rebuilds {[int(p['rebuilds']) for p in pairs]} selects "
                f"{[int(p['selects']) for p in pairs]}")
            log(f"[track:{tag}] wall {wall:.2f} s = {wall / max(len(pairs), 1):.2f}"
                f" s per pair; stage_s {json.dumps(summary['stage_s'])}")
            log(f"[track:{tag}] launches {json.dumps(counts)}")
            if len(pairs) != n_frames - 1:
                raise RuntimeError(f"track {tag}: {len(pairs)} pairs logged")
            if "synthetic" not in res.get("Synthetic", {}):
                raise RuntimeError(f"track {tag}: res.json lacks the run")
            if not all(np.isfinite(e_t + e_r)):
                raise RuntimeError(f"track {tag}: non-finite eT/eR")
            if cfg["knn_method"] != "exact":
                raise RuntimeError(f"track {tag}: knn_method "
                                   f"{cfg['knn_method']}, not exact")
            for name in want:
                if counts[name] < 1:
                    raise RuntimeError(f"track {tag} never launched {name}")
            results[tag] = e_t
        same = results["kcover16"] == results["kcover16_serial"]
        log(f"[track] --no-prefetch per-pair eT bit-equal to the prefetched "
            f"run: {same}")
        if not same:
            raise RuntimeError("prefetched and serial track runs differ")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. device
    smi = smi_line()
    log(f"[device] {smi}")
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. build
    kernels.load()
    log(f"[build] nvcc build of {len(kernels.sources())} sources: "
        f"{kernels.build_seconds if kernels.build_seconds is not None else 0.0:.1f} s")
    build_log = kernels.BUILD_DIR / "build.log"
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"[build] {line.strip()}")

    # 3. kernels vs plain versions
    pair = make_pair()
    entries = check_kernels(pair, dev)
    torch.cuda.empty_cache()

    # 4. main path (K-cover, the product default), twice
    counts4 = tracked_pair(pair, dev, TrackingConfig(max_steps=300), "main")
    for name in ("kcover_step_fwd", "kcover_step_bwd",
                 "kcover_select_records", "project8", "subtile_fwd"):
        if counts4[name] < 1:
            raise RuntimeError(f"main path never launched {name}")
    if counts4["kcover_step_fwd"] != counts4["kcover_step_bwd"]:
        raise RuntimeError("forward and backward step launches differ")
    torch.cuda.empty_cache()

    # 5. the sub-tile path (kcover=0), twice
    counts5 = tracked_pair(pair, dev, TrackingConfig(max_steps=300, kcover=0),
                           "subtile")
    for name in ("project8", "subtile_fwd", "subtile_bwd", "subtile_chain"):
        if counts5[name] < 1:
            raise RuntimeError(f"sub-tile path never launched {name}")
    # every step renders forward and backward; the forward walk runs once
    # more for the pair's depth target
    if not (counts5["subtile_bwd"] == counts5["subtile_chain"]
            == counts5["subtile_fwd"] - 1 == counts5["project8"] - 1):
        raise RuntimeError("forward and backward step launches differ: "
                           f"{counts5}")
    torch.cuda.empty_cache()

    # 6. the track entry point
    run_track_cli()

    counts = dict(counts4, subtile_bwd=counts5["subtile_bwd"],
                  subtile_chain=counts5["subtile_chain"])
    for e in entries:
        # launches on the path that runs the kernel: K-cover (phase 4) for
        # K1-K4, sub-tile (phase 5) for the sub-tile backward
        e["launches"] = counts[e["name"]]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log(smi_line())
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
