#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing carries on on the CPU):

  1. device  — card name and power limit (nvidia-smi), torch/CUDA versions.
  2. build   — first use compiles gsplatloc_tpu_torch/csrc/*.cu with nvcc.
  3. kernels — every hand-written kernel against its plain PyTorch version
               on the card, at the shapes its path gives it (1200x680,
               816,000 splats, K=16; the full-tile kernels through a slot
               buffer built at the pair's displaced pose), with CUDA-event
               timings and the least time the card could take for the same
               work; the index select against its plain version and its
               gathered records against the records select's, both at
               K=16 and at K=12, bit for bit; for the nine walks that
               skip the pixels outside each slot's footprint box (K6a,
               K6b, K7a, K7b and K7c with `_footprint_box`; the sub-tile
               walks K4b, K5a and the selects K3 (K=16) and K8 (K=12)
               with `_subtile_box`), every gate hit of the walked slots
               inside its box, the pairs the boxes hold, how the walk's
               slots fall on the 8 warps of a block, and the kernels'
               registers and spills from the build's -Xptxas -v (K2's
               and K5b's too). The probe K7c runs first and must be
               bit-equal to its plain version before anything else runs;
               K5b also reports its distance from a float64 replay of the
               chain. The sub-tile walks' bounds count the pairs inside
               their boxes, K2's one projection per record it reads.
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
               --kcover 0, and both again with --no-prefetch (their per-pair
               errors must equal the prefetched runs' bit for bit); each
               run writes res.json into a temporary directory.
  7. general — the general rasterizer (backend "pallas", kernels K6a/K6b):
               (a) general_parity on the card against the dense oracle
               (64x128, 300 anisotropic splats, RGB+ED, gradients to every
               Gaussian parameter and the viewmat); (b) the phase-4 pair
               with its depth target from render_depth_gt(backend="pallas")
               tracked by optimize_pose(backend="pallas", max_steps=300),
               twice, launch counters zeroed before each run and read
               after; (c) `cli track --backend pallas` on 4 Synthetic
               frames at 1200x680, 300 iterations, exact kNN.
  8. fulltile — the full-tile fused path (TrackingConfig(subtile=False),
               kernels K7a/K7b, and K7c with compact=True): the phase-4 pair
               with its depth target from render_depth_gt(backend="fused")
               tracked twice with compact off and twice with it on, launch
               counters zeroed before each run and read after; then
               SequenceRunner with that configuration on 4 Synthetic frames
               at 1200x680, 300 iterations, exact kNN, with and without the
               prefetch worker (per-pair errors bit-equal).
  9. kcover-any-K — the K-cover path at K=12, where K * 5 % 8 != 0 routes
               every re-selection through project8 + the index select +
               a row gather, as in the JAX package: (a) the phase-4 pair
               tracked twice by optimize_pose(TrackingConfig(kcover=12)),
               launch counters zeroed before each run and read after (the
               records select never launches); (b) one re-selection timed
               by each route at the phase-3 pose, K=12 and K=16; (c) the
               parity gates on the card at their defaults (128x256):
               subtile_parity and kcover_parity(k_cover=16) must pass,
               kcover_parity(k_cover=12) must give the card the verdict and
               the numbers its plain run on the CPU gives (it fails its
               gate in both packages: K=12 truncates some cover lists of
               that scene); (d) `cli track --dataset Synthetic --kcover 12`
               on 4 frames at 1200x680, exact kNN.
 10. fixture — the Replica fixture suite (`--dataset ReplicaFixture`, its
               frames rendered in worker processes, no files): (a) dense0's
               pair 0 at 1200x680 prepared as the runner prepares it (exact
               kNN, PCA frame, the depth target's scene), its two frames
               rendered while phase 9 runs, and the default path's kernels
               K1-K4 against their plain versions on it as phase 3 holds
               them (K3, K4a and K4b bit-equal, 0 gate hits outside the
               sub-tile boxes); (b) `cli track --dataset ReplicaFixture` in
               process with the reference runs' config (--num-iters 2000,
               exact kNN; patience 200, warmup 100, early stop) on room0
               pairs 0-2, room2 pairs 0-1 (depth noise) and dense0 pairs
               0-1, launch counters zeroed before and read after each run,
               each pair printed beside the reference's record
               (eval/fixture_compare.py); fails if a room's ATE-RMSE is
               above 3x the reference's over the same pairs, a pair's eT
               above 0.05 cm, or a pair's clamp count not the reference's.
 11. tum     — the TUM fixture scenes, read without OpenCV: (a) both
               folders written by the port (data/tum_fixture.py, SUITE's
               arguments) into a temporary directory, desk associating the
               reference's 33 pairs; (b) desk's pair 0 at 624x464 (640x480
               less the crop) prepared as the runner prepares it, and
               K1-K4 against their plain versions as in phase 10a, their
               entries appended to the kernels line with "shape"; (c) `cli
               track --dataset TUM --backend fused --knn exact` in process
               on the first 4 pairs of desk and of stress, launch counters
               zeroed before and read after each run, each pair printed
               beside the reference's record; fails if a prefix's ATE-RMSE
               is above 3x the reference's over the same pairs or a desk
               pair's clamp count is not the reference's (stress, whose
               arguments are not recorded, is held to the reference's
               whole-run ATE-RMSE).
 12. icp     — the classical baselines: `cli icp --dataset ReplicaFixture
               --rooms room0 --max-pairs 5` in process (the four
               point-cloud methods, then HYBRID alone), each pair beside
               the reference's record; fails if ICP, PLANE_ICP or GICP has
               a pair's eT more than 1e-6 m off the reference's, a method's
               ATE-RMSE is above 2x the reference's over the same pairs, or
               HYBRID's dense odometry did not run on the card (its config
               names another device, or it allocated under 100 MiB there).
 13. render  — `cli render` on the card (novel views through K6a): (a)
               `cli render --dataset Synthetic --path spline --n-views 24`
               at 1200x680 in process, launch counters zeroed before and
               read after (K6a once a view, nothing else), its time_block
               timers (frames and path, scene, view, panel), the view's
               device parts timed apart (projection + SH + pack_slots,
               K6a) and the peak device memory of the command's own run
               (above what was allocated before it); one panel decoded must be
               (680, 2400, 3) and lit; (b) K6a on the path's middle view,
               between keyframes, bit-equal to its plain version with 0
               gate hits outside the footprint boxes, timed, its entry
               appended to the kernels line with "shape"; (d) the live
               viewer on a free local port: its /render PNG equal to a
               direct render of its camera; (e) psnr, ssim and lpips
               (random weights, seed 0) of the keyframe view against its
               frame; (f) profile_trace around one view must name K6a's
               kernel; (c) the same command at 320x240 (the JAX package's
               defaults), every view within 1e-3 of the JAX package's
               record (eval/render_reference.json, render_compare.py).
 14. mesh    — tile-row bands (parallel/) on this card, a TileMesh of 4
               bands on cuda:0 (43 tile rows padded to 44, 11 a band):
               (a) K1 and K2 on the last band at its row0_px (528) against
               their plain versions (K1 bit-equal, its rows bit-equal to
               the whole image's; K2 within TOL_BWD_REL), the band buffers
               of K3 per band the whole image's cut at the band
               boundaries, both kernels re-timed at row0_px=0 (entries
               appended to the kernels line with "row0_px", launches from
               (c)); (b) K-cover 16, sub-tile, full-tile and general
               renders at the near pose in bands against one device:
               depth and alpha bit for bit, the viewmat gradient within
               rtol 1e-4 / atol 1e-7 (also over the real cards when there
               are several); (c) the phase-4 pair on one device and twice
               in bands (default path, 300 steps; K=12 and sub-tile, 60;
               general 20, timed only): the band runs bit-equal, eT/eR
               within 2x of the single-device run's, ms per launched step
               beside one device's; (d) two processes (gloo on 127.0.0.1,
               2 bands each on this card) track the pair 20 steps on the
               full-tile path: both ranks bit-equal to this process's 4
               bands, shard_scenes splits 5 rooms [r::2]; (e) `cli track
               --host-shard` on 2 Synthetic frames equals the run without
               it. Prints the peak device memory.

The line before the last is a JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}. Exit code 0 only if every phase passed.
`--phase N` (repeatable; 3-14) runs phases 1, 2 and the phases named
only, and then prints neither line.
"""

from __future__ import annotations

import json
import re
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
from gsplatloc_tpu_torch.ops import fused_tracking as ft
from gsplatloc_tpu_torch.ops import kcover as kc
from gsplatloc_tpu_torch.ops import rasterize_tiles as rt
from gsplatloc_tpu_torch.ops.binning import TILE_H, TILE_W
from gsplatloc_tpu_torch.ops.camera import depth_to_points
from gsplatloc_tpu_torch.ops.fused_tracking import cam_vector
from gsplatloc_tpu_torch.ops.lie import invert_se3, transform_points
from gsplatloc_tpu_torch.opt.tracking import TrackingConfig, optimize_pose

H, W = 680, 1200
FX = 600.0
K_COVER = 16
# the K of phase 9: K * NREC_KC % 8 != 0 takes the index select (K8)
K_INDEX = 12
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
# sub-tile backward, per (slot, pixel) pair inside a walked slot's
# footprint box (the bound counts these, not every pixel of the sub-tile
# the unculled walk met): sub_alpha 23 (sigma 10, negate 1, expf 8,
# opacity 1, clamp 1, gates 2) + the adjoint 22 (1-alpha, T*, live, w,
# phi 2, run 2, suffix, fmax, divide, suffix*inv, T*phi, subtract, gates
# 4, d_sigma 2, w*g_d) + the moment sums 6 (row sum of d_sigma, x*d_sigma
# 2, x^2*d_sigma 2, w*g_d)
OPS_PAIR_BWD = 51
OPS_DECODE = 6  # sub-tile chain: origin decode from moment row 7, per slot
# general rasterizer (csrc/rasterize.cuh, rasterize_fwd.cu, rasterize_bwd.cu),
# per (slot, pixel) pair evaluated: the alive test, dy, sigma 9, negate,
# expf 8, opacity, clamp, two gates + select, the zero test. The bound
# counts only the pairs inside each slot's alpha-gate footprint
# (footprint_pairs), not every pixel of the tile the kernels walk.
OPS_RAST_EVAL = 26
# forward, per pair that passes the gates: 1-alpha, T*, the live test,
# T*alpha, select, 4 channel multiply-adds, the alpha sum
OPS_RAST_FWD_HIT = 14
# backward, per pair that passes the gates: 1-alpha, T*, live, w 2, phi 8,
# run 2, suffix, fmax, divide, T*phi, suffix*inv, subtract, gates 3,
# d_sigma 2, the 10 per-pixel products and sums 23 (the per-slot warp
# shuffles and the fixed-order warp sum are not counted)
OPS_RAST_BWD_HIT = 49
# full-tile path (csrc/fused_tracking.cu): every walked slot is projected
# once per walk (project_parts + the ok gate and the opacity fold, 70);
# per (slot, pixel) pair inside the gate footprints OPS_RAST_EVAL; per pair
# that passes the gates: forward 1-alpha, T*, the live test, T*alpha,
# select, qz*w + acc, the alpha sum (8); probe 1-alpha, T* and the mark
# (3); backward 1-alpha, T*, live, w 2, phi 2, run 2, suffix, fmax, divide,
# T*phi, suffix*inv, subtract, gates 2, d_sigma 2, the 6 products and sums
# 14 (34); per slot with a nonzero sum the pose chain again after its
# projection
OPS_FUSED_SLOT = OPS_PROJECT + 3
OPS_FUSED_FWD_HIT = 8
OPS_FUSED_PROBE_HIT = 3
OPS_FUSED_BWD_HIT = 34

TOL_FWD = 1e-5  # abs, depth_acc / alpha (f32 sum order over K)
TOL_BWD_REL = 1e-4  # rel, 12 pose scalars (f32 sum order over ~14 M terms)
# rel to each row's largest magnitude: the sub-tile moments of d_sigma
# (per-pixel values equal, summed over 256 pixels in another order)
TOL_MOM_REL = 1e-5
# rel to each row's largest magnitude: the general backward's per-slot
# gradients (per-pixel values equal, summed over the tile's 2048 pixels in
# another order)
TOL_RAST_REL = 1e-5


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


def frame_scene(pair, which, dev):
    """The frozen scene of the pair's `which` ("tar" or "src") frame,
    back-projected and placed in the world with the tar camera (816,000
    splats at 1200x680); a pair that carries its scenes (phase 10's,
    prepared as the runner prepares it) gives its own."""
    if "scenes" in pair:
        return pair["scenes"][which]
    K = torch.as_tensor(pair["K"], device=dev)
    tar_c2w = torch.as_tensor(pair["tar_c2w"], device=dev)
    pts = transform_points(tar_c2w, depth_to_points(
        torch.as_tensor(pair[f"{which}_depth"], device=dev), K))
    rgb = torch.as_tensor(pair[f"{which}_rgb"], device=dev).reshape(-1, 3)
    return scene_from_point_cloud(pts, rgb / 255.0, grid_shape=(H, W),
                                  device=dev)


def near_viewmat(pair, dev):
    """The viewmat about a pixel away from the tar pose (the staleness the
    select gate allows), at which the step kernels are checked."""
    from scipy.spatial.transform import Rotation

    step = pair.get("near_step", 1.0)
    delta = np.eye(4, dtype=np.float32)
    delta[:3, :3] = Rotation.from_euler(
        "xyz", np.multiply([0.06, -0.04, 0.03], step),
        degrees=True).as_matrix()
    delta[:3, 3] = np.multiply([0.005, -0.004, 0.006], step)
    tar = torch.as_tensor(pair["tar_c2w"], device=dev).cpu().numpy()
    return invert_se3(torch.as_tensor(tar @ delta, device=dev))


def kernel_entry(name, source, replaces, err, ms, plain_ms, bnd, **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                max_err=err, kernel_ms=ms, **extra)


def check_kernels(pair, dev, path_only=False):
    """Phase 3: each kernel vs its plain version at the main path's shapes.
    path_only (phases 10a, 11b): only the default path's kernels K1-K4,
    with K4a held bit-equal too. A pair with "hw" is checked at that
    (height, width), else at 1200x680."""
    entries = []
    h, w = pair.get("hw", (H, W))  # phase 11's TUM pair: 464x624
    n_ty, n_tx = -(-h // TILE_H), -(-w // TILE_W)
    K = torch.as_tensor(pair["K"], device=dev)
    tar_c2w = torch.as_tensor(pair["tar_c2w"], device=dev)

    # --- K4: the depth-target render of the src cloud from the tar view
    gt_scene = frame_scene(pair, "src", dev)
    vm = invert_se3(tar_c2w)
    slot_p, meta_p, _ = fs.build_subtile_slot_buffer(
        gt_scene, vm, K, w, h, NEAR, FAR)
    cam = cam_vector(vm, K, w, h).contiguous()
    m_pad = slot_p.shape[1]
    p8_k = fs.project8(slot_p, cam, NEAR, FAR)
    p8_p = fs._project8(slot_p, cam, NEAR, FAR)
    torch.cuda.synchronize()
    err = float((p8_k - p8_p).abs().max())
    p8_equal = torch.equal(p8_k, p8_p)
    log(f"[kernels] project8: M_pad={m_pad} max_abs_err={err:.3e} "
        f"bit_equal={p8_equal}")
    if not err <= TOL_FWD or (path_only and not p8_equal):
        raise RuntimeError(f"project8 disagrees with its plain version: {err}")
    ms = time_ms(lambda: fs.project8(slot_p, cam, NEAR, FAR), 50)
    pms = time_ms(lambda: fs._project8(slot_p, cam, NEAR, FAR), 5, warm=1)
    entries.append(kernel_entry(
        "project8", "gsplatloc_tpu_torch/csrc/subtile_fwd.cu",
        "gsplatloc_tpu/ops/fused_subtile.py:655", err, ms, pms,
        bound((5 + 8) * 4 * m_pad, (OPS_PROJECT + 3) * m_pad),
        bit_equal=p8_equal))

    out_k, cd_k = fs.subtile_fwd(p8_k, meta_p, n_ty, n_tx)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p, cd_p = fs._subtile_fwd_plain(p8_p, meta_p, n_ty, n_tx, stats=stats)
    torch.cuda.synchronize()
    pms = (time.perf_counter() - t0) * 1e3
    err = float((out_k - out_p).abs().max())
    bit_equal = torch.equal(out_k, out_p)
    cd_equal = torch.equal(cd_k, cd_p)
    log(f"[kernels] subtile_fwd: M_out={out_k.shape[1]} max_abs_err={err:.3e} "
        f"bit_equal={bit_equal} chunks_done_equal={cd_equal} "
        f"chunks_walked={int(cd_k.sum())} (full size, no crop)")
    if not (bit_equal and cd_equal):
        raise RuntimeError("subtile_fwd disagrees with its plain version: "
                           f"err={err} chunks_done_equal={cd_equal}")
    walked = int(cd_k.sum()) * fs.CHUNK
    cull = subtile_box_check(p8_k, meta_p, cd_k.long() * fs.CHUNK, n_tx)
    regs, spill_st, spill_ld = ptxas_usage("subtile_fwd_kernel")
    log_cull("subtile_fwd", cull, None, walked, regs, spill_st, spill_ld)
    ms = time_ms(lambda: fs.subtile_fwd(p8_k, meta_p, n_ty, n_tx), 20)
    # operations: the staging of every walked slot, and the pair work only
    # for the pairs inside the walked slots' footprint boxes (every gate
    # hit lies inside; the unculled count was live slots x 256)
    entries.append(kernel_entry(
        "subtile_fwd", "gsplatloc_tpu_torch/csrc/subtile_fwd.cu",
        "gsplatloc_tpu/ops/fused_subtile.py:737", err, ms, pms,
        bound(walked * 8 * 4 + 2 * 4 * out_k.shape[1]
              + 4 * (cd_k.numel() + meta_p.numel()),
              cull["box_pairs"] * OPS_PAIR_WALK + walked * OPS_COEFF),
        walked_slots=walked, live_slot_pairs=stats["pairs"],
        box_pairs=cull["box_pairs"], gate_hits=cull["hits"],
        gate_hits_outside_box=cull["outside"], regs=regs,
        spill_stores=spill_st, spill_loads=spill_ld))
    del slot_p, p8_k, p8_p, out_p, gt_scene

    # --- K3: select at the init pose of the tracking scene
    scene = frame_scene(pair, "tar", dev)
    slot3d, meta, ovf = kc.build_kcover_slot_buffer(
        scene, vm, K, w, h, NEAR, FAR)
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
    if not torch.equal(kb_k, kb_p) or not r_err <= TOL_FWD:
        raise RuntimeError("kcover_select_records disagrees with its plain "
                           f"version: records {err}, render {r_err}")
    p8 = fs.project8(slot3d, cam, NEAR, FAR)
    cull = subtile_box_check(p8, meta, stats["seg_slots"], n_tx)
    regs, spill_st, spill_ld = ptxas_usage("kcover_select_kernelILb0E")
    log_cull("kcover_select_records", cull, None, stats["slots"], regs,
             spill_st, spill_ld)
    ms = time_ms(lambda: kc.select_kcover_records(
        slot3d, meta, cam, n_ty, n_tx, K_COVER, NEAR, FAR), 20)
    entries.append(kernel_entry(
        "kcover_select_records", "gsplatloc_tpu_torch/csrc/kcover_select.cu",
        "gsplatloc_tpu/ops/kcover.py:511", err, ms, pms,
        bound(stats["slots"] * 5 * 4 + kb_k.numel() * 4 + meta.numel() * 4,
              cull["box_pairs"] * OPS_PAIR_SELECT
              + stats["slots"] * (OPS_PROJECT + OPS_COEFF)),
        render_err=r_err, walked_slots=stats["slots"],
        live_slot_pairs=stats["pairs"], box_pairs=cull["box_pairs"],
        gate_hits=cull["hits"], gate_hits_outside_box=cull["outside"],
        regs=regs, spill_stores=spill_st, spill_loads=spill_ld))
    del kb_p, r_k, r_p
    if not path_only:
        entries.append(check_index_select(slot3d, meta, cam, p8, kb_k, n_ty,
                                          n_tx))
    del p8
    del slot3d

    # --- K1 / K2: the step render at a pose about a pixel away from the
    # selection pose (the staleness the select gate allows), so that every
    # gradient path is live
    cam_s = cam_vector(near_viewmat(pair, dev), K, w, h).contiguous()
    m_out = kb_k.shape[2]
    f_k = kc.kcover_step_fwd(kb_k, cam_s, n_ty, n_tx, NEAR, FAR)
    f_p = kc._kcover_step_fwd_plain(kb_k, cam_s, n_ty, n_tx, NEAR, FAR)
    err = float((f_k - f_p).abs().max())
    bnd_f, bnd_b, needed = step_bounds(kb_k, cam_s, n_ty, n_tx)
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
        "gsplatloc_tpu/ops/kcover.py:940", err, ms, pms, bnd_f,
        records_needed=needed))

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    g_d = torch.randn(m_out, generator=gen).to(dev)
    g_a = torch.randn(m_out, generator=gen).to(dev)
    # the backward reads the forward's rows (one sweep over the records)
    b_k = kc.kcover_step_bwd(kb_k, cam_s, n_ty, n_tx, NEAR, FAR, g_d, g_a,
                             f_k)
    b_k2 = kc.kcover_step_bwd(kb_k, cam_s, n_ty, n_tx, NEAR, FAR, g_d, g_a,
                              f_k)
    b_p = kc._kcover_step_bwd_plain(kb_k, cam_s, n_ty, n_tx, NEAR, FAR, g_d,
                                    g_a, f_k)
    torch.cuda.synchronize()
    err = float((b_k - b_p).abs().max())
    rel = err / float(b_p.abs().max())  # relative to the largest scalar
    rel_n = float((b_k - b_p).norm() / b_p.norm())
    repeat = torch.equal(b_k, b_k2)
    regs, spill_st, spill_ld = ptxas_usage("kcover_step_bwd_kernel")
    log(f"[kernels] kcover_step_bwd: max_abs_err={err:.3e} "
        f"max_rel_err={rel:.3e} rel_norm_err={rel_n:.3e} "
        f"bitwise_repeatable={repeat}; registers {regs}, spill "
        f"stores/loads {spill_st}/{spill_ld} bytes")
    if not rel <= TOL_BWD_REL or not repeat:
        raise RuntimeError(f"kcover_step_bwd disagrees: rel {rel}, "
                           f"repeatable {repeat}")
    ms = time_ms(lambda: kc.kcover_step_bwd(
        kb_k, cam_s, n_ty, n_tx, NEAR, FAR, g_d, g_a, f_k), 50)
    pms = time_ms(lambda: kc._kcover_step_bwd_plain(
        kb_k, cam_s, n_ty, n_tx, NEAR, FAR, g_d, g_a, f_k), 3, warm=1)
    entries.append(kernel_entry(
        "kcover_step_bwd", "gsplatloc_tpu_torch/csrc/kcover_step.cu",
        "gsplatloc_tpu/ops/kcover.py:964", err, ms, pms, bnd_b,
        max_rel_err=rel, regs=regs, spill_stores=spill_st,
        spill_loads=spill_ld))
    del kb_k
    if not path_only:
        entries += check_subtile_bwd(scene, vm, cam_s, K, dev, n_ty, n_tx)
    return entries


def step_bounds(kb, cam, n_ty, n_tx):
    """(K1's bound, K2's bound, records needed) of the step at `cam`. K1:
    the records each pixel reads until its transmittance is dead, once,
    and its two rows; one projection and one alpha per needed record. K2:
    the same records, the two cotangent rows and the forward's two rows,
    the 12 scalars; the chain per contributing record besides."""
    m_out = kb.shape[2]
    pieces = kc._kcover_fwd_pieces(kb, cam, n_ty, n_tx, NEAR, FAR)
    needed = int((pieces[5] > kc.T_EPS).sum())  # records read until dead
    chained = int((pieces[3] & (pieces[5] > kc.T_EPS)).sum())
    del pieces
    ops = needed * (OPS_PROJECT + OPS_ALPHA_DIRECT)
    return (bound(needed * 5 * 4 + 2 * 4 * m_out, ops),
            bound(needed * 5 * 4 + 4 * 4 * m_out + 48,
                  ops + chained * OPS_CHAIN), needed)


def check_index_select(slot3d, meta, cam, p8, kb_k, n_ty, n_tx):
    """K8 on the phase-3 K-cover slot buffer, fed by K4a (p8): bit-equal
    to its plain version at K=16 and at K=12, and its columns gathered
    into records (the index route of build_kcover_buffer) bit-equal to
    K3's records at K=16 (kb_k) and at K=12. The row's time, plain time,
    footprint cull and bound are those at K=12, the K of the path that
    launches K8 (phase 9); the K=16 time rides along as ms_k16."""
    dummy = float(slot3d.shape[1])
    runs = {}
    for k in (K_COVER, K_INDEX):
        idx_k = kc.select_kcover(p8, meta, n_ty, n_tx, k)
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx_p = kc._select_index_plain(p8, meta, n_ty, n_tx, k, stats=stats)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        err = float((idx_k - idx_p).abs().max())
        bit_equal = torch.equal(idx_k, idx_p)
        filled = float((idx_k != dummy).float().mean())
        del idx_p
        kb_r = kb_k if k == K_COVER else kc.select_kcover_records(
            slot3d, meta, cam, n_ty, n_tx, k, NEAR, FAR)
        gathered = torch.equal(kc.build_kcover_buffer(
            slot3d, meta, cam, n_ty, n_tx, NEAR, FAR, k_cover=k,
            via="gather"), kb_r)
        del kb_r
        log(f"[kernels] kcover_select: B_pad={slot3d.shape[1]} K={k} "
            f"max_abs_err={err:.3e} bit_equal={bit_equal} "
            f"filled={filled:.4f}; gathered records bit-equal to "
            f"kcover_select_records: {gathered} (full size, no crop)")
        if not (bit_equal and gathered):
            raise RuntimeError(
                f"kcover_select at K={k} disagrees: with its plain version "
                f"{bit_equal} (err {err}), gathered records vs the records "
                f"select {gathered}")
        ms = time_ms(lambda: kc.select_kcover(p8, meta, n_ty, n_tx, k), 20)
        runs[k] = dict(err=err, ms=ms, pms=pms, stats=stats,
                       out_bytes=idx_k.numel() * 4)
        del idx_k
    r = runs[K_INDEX]
    cull = subtile_box_check(p8, meta, r["stats"]["seg_slots"], n_tx)
    regs, spill_st, spill_ld = ptxas_usage("kcover_select_kernelILb1E")
    log_cull(f"kcover_select (K={K_INDEX})", cull, None, r["stats"]["slots"],
             regs, spill_st, spill_ld)
    return kernel_entry(
        "kcover_select", "gsplatloc_tpu_torch/csrc/kcover_select.cu",
        "gsplatloc_tpu/ops/kcover.py:540",
        max(r["err"], runs[K_COVER]["err"]), r["ms"], r["pms"],
        bound(r["stats"]["slots"] * 8 * 4 + r["out_bytes"] + meta.numel() * 4,
              cull["box_pairs"] * OPS_PAIR_SELECT
              + r["stats"]["slots"] * OPS_COEFF),
        k_cover=K_INDEX, walked_slots=r["stats"]["slots"],
        live_slot_pairs=r["stats"]["pairs"], box_pairs=cull["box_pairs"],
        gate_hits=cull["hits"], gate_hits_outside_box=cull["outside"],
        regs=regs, spill_stores=spill_st, spill_loads=spill_ld,
        ms_k16=runs[K_COVER]["ms"])


def check_subtile_bwd(scene, vm, cam_s, K, dev, n_ty, n_tx):
    """K5a / K5b at the kcover=0 path's shapes: the tracking scene's
    sub-tile slot buffer built at the init pose, rendered at a pose about a
    pixel away (K5a walks the chunks of that forward), with cotangents made
    from a numpy seed."""
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
    mom_k = fs.subtile_bwd(p8, sin, meta, n_ty, n_tx, cd)
    mom_k2 = fs.subtile_bwd(p8, sin, meta, n_ty, n_tx, cd)
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
    cull = subtile_box_check(p8, meta, cd.long() * fs.CHUNK, n_tx)
    regs, spill_st, spill_ld = ptxas_usage("subtile_bwd_kernel")
    log_cull("subtile_bwd", cull, None, walked, regs, spill_st, spill_ld)
    ms = time_ms(lambda: fs.subtile_bwd(p8, sin, meta, n_ty, n_tx, cd), 20)
    # operations: the staging of every walked slot, and the full pair work
    # only for the pairs inside the walked slots' footprint boxes (every
    # gate hit lies inside; the unculled count was live slots x 256)
    entries.append(kernel_entry(
        "subtile_bwd", "gsplatloc_tpu_torch/csrc/subtile_bwd.cu",
        "gsplatloc_tpu/ops/fused_subtile.py:782", err, ms, pms,
        bound(walked * 8 * 4 + 4 * 4 * m_out + 8 * 4 * m_pad
              + 4 * (meta.numel() + cd.numel()),
              cull["box_pairs"] * OPS_PAIR_BWD + walked * OPS_COEFF),
        max_rel_err=max(rel_rows), walked_slots=walked,
        live_slot_pairs=stats["pairs"], box_pairs=cull["box_pairs"],
        gate_hits=cull["hits"], gate_hits_outside_box=cull["outside"],
        multi_warp_slots=cull["multi_warp_slots"], regs=regs,
        spill_stores=spill_st, spill_loads=spill_ld))
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
    f64_rel, f64_rel_plain = chain_f64_errors(slot, mom_k, cam_s, meta, n_tx,
                                              d_k, d_p)
    lo, hi = int(meta[1]), int(meta[-1])
    in_range = hi - lo
    nonzero = int((mom_k[:7, lo:hi] != 0).any(dim=0).sum())
    regs, spill_st, spill_ld = ptxas_usage("subtile_chain_kernel")
    log(f"[kernels] subtile_chain: slots_in_range={in_range} "
        f"slots_with_moments={nonzero} max_abs_err={err:.3e} "
        f"max_rel_err={rel:.3e} bitwise_repeatable={repeat}; from the "
        f"float64 replay {f64_rel:.3e} (plain version {f64_rel_plain:.3e}); "
        f"registers {regs}, spill stores/loads {spill_st}/{spill_ld} bytes")
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
        max_rel_err=rel, f64_rel_err=f64_rel, slots_with_moments=nonzero,
        regs=regs, spill_stores=spill_st, spill_loads=spill_ld))
    return entries


def chain_f64_errors(slot, mom, cam, meta, n_tx, *ds):
    """Distance of each pose partial row in ds from the chain replayed in
    float64 on the same f32 inputs (`_chain_xla` on doubles), relative to
    the replay's largest scalar."""
    d64 = fs._chain_xla(slot.double(), mom.double(), cam.double(), meta,
                        n_tx)
    top = float(d64.abs().max())
    return [float((d.double() - d64).abs().max()) / top for d in ds]


def walked_slots(meta, cd):
    """In-segment slots of the chunks each tile's walk reached."""
    n = cd.shape[0]
    starts, ends = meta[1:1 + n].long(), meta[2:2 + n].long()
    reach = (starts // rt.CHUNK) * rt.CHUNK + cd.long() * rt.CHUNK
    return int((torch.minimum(ends, reach) - starts).clamp_min(0).sum())


def footprint_pairs(records, meta, cd, n_tx):
    """(slot, pixel) pairs the general walk needs: for each in-segment slot
    of the chunks each tile's walk reached, the pixels of its tile whose
    centre lies in the bounding box of the slot's alpha-gate footprint
    sigma <= ln(255 * opacity) (sigma = 0.5 d^T Q d, Q the conic: half
    extents sqrt(2 ln(255 opa) Q^-1_xx) and sqrt(2 ln(255 opa) Q^-1_yy)).
    Every pair that passes the gates lies inside; a walk limited to these
    boxes composites the same images."""
    n = cd.shape[0]
    starts, ends = meta[1:1 + n].long(), meta[2:2 + n].long()
    reach = (starts // rt.CHUNK) * rt.CHUNK + cd.long() * rt.CHUNK
    counts = (torch.minimum(ends, reach) - starts).clamp_min(0)
    tile = torch.repeat_interleave(torch.arange(n, device=cd.device), counts)
    first = torch.cumsum(counts, 0) - counts
    slot = starts[tile] + torch.arange(tile.numel(), device=cd.device) \
        - first[tile]
    mx, my, qa, qb, qc, _z, opa = records[:7, slot].double()
    det = qa * qc - qb * qb
    s0 = torch.log(255.0 * opa)
    ok = (s0 >= 0) & (det > 0) & (qa > 0) & (qc > 0)
    # a conic that is not positive definite has no bounded footprint: its
    # whole tile is counted
    degenerate = (s0 >= 0) & ~ok
    s0 = torch.where(ok, s0, 0.0)
    det = torch.where(ok, det, 1.0)
    # a hair wide, so that f32 rounding at the rim stays inside
    hx = torch.sqrt(2.0 * s0 * qc.abs() / det) * (1 + 1e-6) + 1e-4
    hy = torch.sqrt(2.0 * s0 * qa.abs() / det) * (1 + 1e-6) + 1e-4
    x0 = (tile % n_tx).double() * TILE_W
    y0 = (tile // n_tx + meta[0].long()).double() * TILE_H

    def span(c, h, o, size):
        lo = torch.ceil(c - h - 0.5 - o).clamp(0, size - 1)
        hi = torch.floor(c + h - 0.5 - o).clamp(-1, size - 1)
        return (hi - lo + 1).clamp_min(0)

    nx, ny = span(mx, hx, x0, TILE_W), span(my, hy, y0, TILE_H)
    return int(torch.where(ok, nx * ny, 0.0).sum()
               + degenerate.sum() * (TILE_H * TILE_W))


def box_check(records, meta, cd, n_tx):
    """The footprint cull of the tile walks (K6a, K6b, K7a, K7b) against the
    gates, over every chunk each tile's walk reached. records: fields 0-4
    and 6 as the kernels read them (for the full-tile walks the projected
    rows with opacity * ok).
    Returns a dict: `hits`, the (slot, pixel) pairs that pass
    `_chunk_alpha`'s gates, dead pixels included; `outside`, those of them
    outside their slot's `_footprint_box`, which must be 0; `box_pairs`,
    the pairs inside the boxes of the walked in-segment slots, which a
    culled walk evaluates at most; `met_warps`, the (slot, warp) pairs whose
    box meets the warp's 32x8 pixel rectangle, and `multi_warp_slots`, the
    slots met by more than one warp; and per tile on average the walk's
    balance over the 8 warps, in met (slot, warp) pairs: `chunk_sync`, the
    sum over chunks of the busiest warp's (what warps that wait for each
    other every chunk take), `busiest_warp` (what warps that walk on their
    own take) and `mean_warp`."""
    n = cd.shape[0]
    dev = records.device
    starts, ends, base, _ = rt._tile_bounds(meta, n)
    px, py = rt._pixel_xy(n // n_tx, n_tx, meta[0].long(), dev)
    t = torch.arange(n, device=dev)
    x0 = (t % n_tx).float() * TILE_W
    y0 = (t // n_tx + meta[0].long()).float() * TILE_H
    col = torch.arange(rt.P, device=dev) % TILE_W
    row = torch.arange(rt.P, device=dev) // TILE_W
    out = dict(hits=0, outside=0, box_pairs=0, met_warps=0,
               multi_warp_slots=0)
    chunk_sync = torch.zeros(n, device=dev)
    per_warp = torch.zeros((n, 8), device=dev)
    cdl = cd.long()
    for c in range(int(cdl.max()) if n else 0):
        act = torch.nonzero(c < cdl)[:, 0]
        alpha, _dx, _dy, in_seg, rec = rt._chunk_alpha(
            records, base[act] + c * rt.CHUNK, starts[act], ends[act],
            px[act], py[act])
        del _dx, _dy
        c_lo, c_hi, r_lo, r_hi = rt._footprint_box(
            rec[0], rec[1], rec[2], rec[3], rec[4], rec[6],
            x0[act][:, None], y0[act][:, None])
        inside = ((col >= c_lo[..., None]) & (col <= c_hi[..., None])
                  & (row >= r_lo[..., None]) & (row <= r_hi[..., None]))
        hit = alpha > 0.0
        out["hits"] += int(hit.sum())
        out["outside"] += int((hit & ~inside).sum())
        del alpha, inside, hit
        area = (c_hi - c_lo + 1).clamp_min(0) * (r_hi - r_lo + 1).clamp_min(0)
        out["box_pairs"] += int(area[in_seg].sum())
        # the warps whose pixel rectangle each box meets (rasterize.cuh
        # box_warps): column bands of 32, row bands of 8
        band_c = ((torch.arange(4, device=dev) * 32 <= c_hi[..., None])
                  & (torch.arange(4, device=dev) * 32 + 31 >= c_lo[..., None]))
        band_r = ((torch.arange(2, device=dev) * 8 <= r_hi[..., None])
                  & (torch.arange(2, device=dev) * 8 + 7 >= r_lo[..., None]))
        met = (band_r[..., :, None] & band_c[..., None, :]).flatten(-2)
        met = met & in_seg[..., None] & (area > 0)[..., None]  # (n, C, 8)
        n_met = met.sum(-1)
        out["met_warps"] += int(n_met.sum())
        out["multi_warp_slots"] += int((n_met > 1).sum())
        per_chunk = met.sum(1).float()  # (n, 8)
        chunk_sync[act] += per_chunk.max(dim=1).values
        per_warp[act] += per_chunk
    out["chunk_sync"] = float(chunk_sync.mean())
    out["busiest_warp"] = float(per_warp.max(dim=1).values.mean())
    out["mean_warp"] = float(per_warp.mean())
    return out


def subtile_box_check(p8, meta, n_walk, n_tx, batch=512):
    """The footprint cull of the sub-tile walks (K4b, K5a, K3 and K8)
    against the gates, over the first n_walk[s] slots of each segment s
    (the slots its walk reached): box_check's counts with `_subtile_box`
    for the boxes, `_sub_alpha` for the gates and the 8 warps of a
    sub-tile block (warp w: pixel rows 2w and 2w+1), taken in 128-slot
    chunks."""
    n = n_walk.shape[0]
    dev = p8.device
    starts, _ = fs._segment_bounds(meta, n)
    x0, y0 = fs._segment_origins(meta, n, n_tx)
    mono = fs._sub_mono(dev)
    flat = torch.arange(fs.P_SUB, device=dev)
    row, col = flat // fs.SUB_W, flat % fs.SUB_W
    w_ids = torch.arange(8, device=dev)
    out = dict(hits=0, outside=0, box_pairs=0, met_warps=0,
               multi_warp_slots=0)
    chunk_sync = torch.zeros(n, device=dev)
    per_warp = torch.zeros((n, 8), device=dev)
    nw = n_walk.to(dev).long()
    cdl = (nw + fs.CHUNK - 1) // fs.CHUNK
    lane = torch.arange(fs.CHUNK, device=dev)
    for c in range(int(cdl.max()) if n else 0):
        act_all = torch.nonzero(c < cdl)[:, 0]
        for act in act_all.split(batch):
            m = act.numel()
            # the walked slots of this chunk
            walked = (c * fs.CHUNK + lane[None, :] < nw[act][:, None])
            walked = walked.reshape(-1)
            idx = (starts[act][:, None] + c * fs.CHUNK
                   + lane[None, :]).reshape(-1).clamp_max(p8.shape[1] - 1)
            xa = x0[act].repeat_interleave(fs.CHUNK)
            ya = y0[act].repeat_interleave(fs.CHUNK)
            rec = p8[:, idx]
            coef = fs._coeff_mat(rec, xa[None, :], ya[None, :])
            c_lo, c_hi, r_lo, r_hi = fs._subtile_box(coef, rec[0] - xa,
                                                     rec[1] - ya)
            hit = (fs._sub_alpha(coef, mono) > 0.0) & walked[:, None]
            inside = ((col >= c_lo[:, None]) & (col <= c_hi[:, None])
                      & (row >= r_lo[:, None]) & (row <= r_hi[:, None]))
            out["hits"] += int(hit.sum())
            out["outside"] += int((hit & ~inside).sum())
            del hit, inside
            area = ((c_hi - c_lo + 1).clamp_min(0)
                    * (r_hi - r_lo + 1).clamp_min(0)) * walked
            out["box_pairs"] += int(area.sum())
            met = ((area > 0)[:, None] & (r_lo[:, None] <= 2 * w_ids + 1)
                   & (r_hi[:, None] >= 2 * w_ids)).reshape(m, fs.CHUNK, 8)
            n_met = met.sum(-1)
            out["met_warps"] += int(n_met.sum())
            out["multi_warp_slots"] += int((n_met > 1).sum())
            per_chunk = met.sum(1).float()  # (m, 8)
            chunk_sync[act] += per_chunk.max(dim=1).values
            per_warp[act] += per_chunk
    out["chunk_sync"] = float(chunk_sync.mean())
    out["busiest_warp"] = float(per_warp.max(dim=1).values.mean())
    out["mean_warp"] = float(per_warp.mean())
    return out


def log_cull(name, cull, needed, walked, regs, spill_st, spill_ld):
    """Print box_check's counts for one kernel; raise on a gate hit outside
    its box."""
    fp = "" if needed is None else f" (footprint_pairs {needed})"
    log(f"[kernels] {name} footprint cull: gate hits {cull['hits']} in the "
        f"walked chunks, {cull['outside']} outside their boxes; box_pairs "
        f"{cull['box_pairs']}{fp}; warps met per "
        f"walked slot {cull['met_warps'] / max(walked, 1):.4f}, slots met "
        f"by several warps {cull['multi_warp_slots']}; per tile, met (slot, "
        f"warp) pairs of the busiest warp summed over chunks "
        f"{cull['chunk_sync']:.1f}, over the walk {cull['busiest_warp']:.1f}"
        f", mean warp {cull['mean_warp']:.1f}; registers {regs}, spill "
        f"stores/loads {spill_st}/{spill_ld} bytes")
    if cull["outside"] != 0:
        raise RuntimeError(f"{name}: {cull['outside']} gate hits outside the "
                           "footprint boxes")


def ptxas_usage(kernel):
    """(registers, spill store bytes, spill load bytes) of one kernel from
    this run's build log (nvcc -Xptxas -v), or (None, None, None) when
    the library was not built in this run."""
    log_path = kernels.BUILD_DIR / "build.log"
    if not log_path.exists():
        return None, None, None
    regs = spill_st = spill_ld = None
    found = False
    for line in log_path.read_text().splitlines():
        if "Compiling entry function" in line:
            found = kernel in line
        elif found and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            spill_st, spill_ld = (int(v) for v, _ in nums)
        elif found and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            found = False
    return regs, spill_st, spill_ld


def check_raster_fwd(packed, meta, b, tag, where, **extra):
    """K6a on one slot buffer against its plain version on the card:
    bit-equal, chunks_done equal, every gate hit inside its slot's
    footprint box; its time with CUDA events and its bound (the walked
    slots' records, the five planes, the pairs inside the footprints).
    Returns the kernels-line entry and what the backward check reuses."""
    n_ty, n_tx = b.n_tiles_y, b.n_tiles_x
    m_pad = packed.shape[1]
    out_k, cd_k = rt.rasterize_fwd(packed, meta, n_ty, n_tx)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p, cd_p = rt._composite_fwd_plain(packed, meta, n_ty, n_tx,
                                          stats=stats)
    torch.cuda.synchronize()
    pms = (time.perf_counter() - t0) * 1e3
    err = float((out_k - out_p).abs().max())
    bit_equal = torch.equal(out_k, out_p)
    cd_equal = torch.equal(cd_k, cd_p)
    walked = walked_slots(meta, cd_k)
    needed = footprint_pairs(packed, meta, cd_k, n_tx)
    log(f"[kernels] {tag}: M={b.num_pairs} M_pad={m_pad} tiles="
        f"{n_ty}x{n_tx} walked_slots={walked} walked_pairs={stats['pairs']} "
        f"footprint_pairs={needed} hits={stats['hits']} max_abs_err="
        f"{err:.3e} bit_equal={bit_equal} chunks_done_equal={cd_equal} "
        f"{where}")
    if not (bit_equal and cd_equal):
        raise RuntimeError(f"{tag} disagrees with its plain version: "
                           f"err={err} chunks_done_equal={cd_equal}")
    if needed < stats["hits"]:
        raise RuntimeError(f"footprint count {needed} below the gate hits "
                           f"{stats['hits']}")
    del out_p
    # K6a and K6b walk the same chunks with the same boxes
    cull = box_check(packed, meta, cd_k, n_tx)
    regs, spill_st, spill_ld = ptxas_usage("rasterize_fwd_kernel")
    log_cull(tag, cull, needed, walked, regs, spill_st, spill_ld)
    ms = time_ms(lambda: rt.rasterize_fwd(packed, meta, n_ty, n_tx), 20)
    entry = kernel_entry(
        "rasterize_fwd", "gsplatloc_tpu_torch/csrc/rasterize_fwd.cu",
        "gsplatloc_tpu/ops/rasterize_pallas.py:387", err, ms, pms,
        bound(walked * rt.N_FIELDS * 4 + out_k.numel() * 4
              + 4 * (cd_k.numel() + meta.numel()),
              needed * OPS_RAST_EVAL + stats["hits"] * OPS_RAST_FWD_HIT),
        walked_slots=walked, walked_pairs=stats["pairs"],
        footprint_pairs=needed, hits=stats["hits"],
        box_pairs=cull["box_pairs"], gate_hits_outside_box=cull["outside"],
        regs=regs, spill_stores=spill_st, spill_loads=spill_ld, **extra)
    log(f"[kernels] {tag}: {ms:.4f} ms (CUDA events, 20 launches), bound "
        f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}), plain "
        f"{pms:.1f} ms")
    return dict(entry=entry, out=out_k, chunks_done=cd_k, cull=cull,
                needed=needed, walked=walked, stats=stats)


def check_rasterize(pair, dev):
    """K6a / K6b at the general path's full shapes: the tracking scene
    (816,000 isotropic splats) projected at the initial pose, its SH
    colours evaluated, binned by bin_and_sort (inverse permutation kept)
    and gathered into the (16, M_pad) slot buffer; the backward's depth and
    alpha cotangents from the tracking loss of that render against the src
    frame's depth, its r/g/b cotangents from a numpy seed (the tracking
    loss gives them zero) so that rows 7-9 are exercised."""
    from gsplatloc_tpu_torch.losses import tracking_loss

    entries = []
    K = torch.as_tensor(pair["K"], device=dev)
    scene = frame_scene(pair, "tar", dev)
    packed, meta, b = pack_view(scene, K, pair["tar_c2w"], dev)
    del scene
    n_ty, n_tx = b.n_tiles_y, b.n_tiles_x
    fwd = check_raster_fwd(packed, meta, b, "rasterize_fwd",
                           "(full size, no crop)")
    entries.append(fwd["entry"])
    out_k, cd_k, cull = fwd["out"], fwd["chunks_done"], fwd["cull"]
    needed, walked, stats = fwd["needed"], fwd["walked"], fwd["stats"]

    # cotangents of the five images
    d_acc = out_k[3].clone().requires_grad_(True)
    alpha = out_k[4].clone().requires_grad_(True)
    depth = (d_acc / alpha.clamp_min(1e-10))[:H, :W]
    target = torch.as_tensor(pair["src_depth"], device=dev)
    g_d, g_a = torch.autograd.grad(tracking_loss(depth, target).total,
                                   (d_acc, alpha))
    rng = np.random.default_rng(SEED)
    g_rgb = torch.as_tensor(rng.standard_normal(
        (3,) + tuple(g_d.shape)).astype(np.float32), device=dev)
    px_in = torch.cat([out_k, g_rgb * g_d.std(), g_d[None], g_a[None]])
    px_in = px_in.contiguous()
    g_k = rt.rasterize_bwd(packed, meta, cd_k, px_in, n_ty, n_tx)
    g_k2 = rt.rasterize_bwd(packed, meta, cd_k, px_in, n_ty, n_tx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_p = rt._composite_bwd_plain(packed, meta, cd_k, px_in, n_ty, n_tx)
    torch.cuda.synchronize()
    pms = (time.perf_counter() - t0) * 1e3
    rel_rows = [float((g_k[r] - g_p[r]).abs().max()
                      / g_p[r].abs().max().clamp_min(1e-30))
                for r in range(rt.N_FIELDS)]
    err = float((g_k - g_p).abs().max())
    zeros_equal = torch.equal((g_k == 0).all(dim=0), (g_p == 0).all(dim=0))
    pad_zero = bool((g_k[rt.N_FIELDS:] == 0).all())
    repeat = torch.equal(g_k, g_k2)
    log(f"[kernels] rasterize_bwd: max_abs_err={err:.3e} max_rel_err_by_row="
        f"{[float(f'{x:.3e}') for x in rel_rows]} zero_fill_equal="
        f"{zeros_equal} rows_10_15_zero={pad_zero} bitwise_repeatable="
        f"{repeat} (full size, no crop)")
    if not (max(rel_rows) <= TOL_RAST_REL and zeros_equal and pad_zero
            and repeat):
        raise RuntimeError("rasterize_bwd disagrees with its plain version: "
                           f"rows {rel_rows}, zero-fill {zeros_equal}, "
                           f"pad rows zero {pad_zero}, repeatable {repeat}")
    del g_k2, g_p
    regs, spill_st, spill_ld = ptxas_usage("rasterize_bwd_kernel")
    log_cull("rasterize_bwd", cull, needed, walked, regs, spill_st, spill_ld)
    ms = time_ms(lambda: rt.rasterize_bwd(packed, meta, cd_k, px_in, n_ty,
                                          n_tx), 10)
    entries.append(kernel_entry(
        "rasterize_bwd", "gsplatloc_tpu_torch/csrc/rasterize_bwd.cu",
        "gsplatloc_tpu/ops/rasterize_pallas.py:404", err, ms, pms,
        bound(walked * rt.N_FIELDS * 4 + px_in.numel() * 4
              + g_k.numel() * 4 + 4 * (cd_k.numel() + meta.numel()),
              needed * OPS_RAST_EVAL + stats["hits"] * OPS_RAST_BWD_HIT),
        max_rel_err=max(rel_rows), walked_slots=walked,
        footprint_pairs=needed, box_pairs=cull["box_pairs"],
        gate_hits_outside_box=cull["outside"],
        multi_warp_slots=cull["multi_warp_slots"], regs=regs,
        spill_stores=spill_st, spill_loads=spill_ld))
    return entries


def check_fused_tracking(pair, dev):
    """K7a / K7b / K7c at the full-tile path's shapes: the tracking scene
    (816,000 splats) binned into 16x128 tiles by build_slot_buffer at the
    pair's displaced pose and rendered there (the state right after a
    rebuild, where the probe's compaction is exact); the backward's
    cotangents from the tracking loss of that render against the tar
    frame's depth."""
    from gsplatloc_tpu_torch.losses import tracking_loss

    entries = []
    K = torch.as_tensor(pair["K"], device=dev)
    scene = frame_scene(pair, "tar", dev)
    vm = invert_se3(torch.as_tensor(pair["src_c2w"], device=dev))
    slot, meta, b = ft.build_slot_buffer(scene, vm, K, W, H, NEAR, FAR)
    del scene
    n_ty, n_tx = b.n_tiles_y, b.n_tiles_x
    m_pad = slot.shape[1]
    cam = cam_vector(vm, K, W, H).contiguous()

    # K7c first: its walk is K7a's, and a miscompiled no-op in a walk has
    # lost alpha before (nvcc 12.8, K7a), so nothing runs before the probe
    # is bit-equal to its plain version at full size
    c_k, pcd_k = ft.fused_probe(slot, meta, cam, n_ty, n_tx, NEAR, FAR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c_p, pcd_p = ft._fused_probe_plain(slot, meta, cam, n_ty, n_tx, NEAR, FAR)
    torch.cuda.synchronize()
    probe_pms = (time.perf_counter() - t0) * 1e3
    probe_err = float((c_k - c_p).abs().max())
    log(f"[kernels] fused_probe: contrib_equal={torch.equal(c_k, c_p)} "
        f"chunks_done_equal={torch.equal(pcd_k, pcd_p)} (full size, no "
        "crop)")
    if not (torch.equal(c_k, c_p) and torch.equal(pcd_k, pcd_p)):
        raise RuntimeError(f"fused_probe disagrees with its plain version: "
                           f"contrib err {probe_err}, chunks done equal "
                           f"{torch.equal(pcd_k, pcd_p)}")
    del c_p, pcd_p

    out_k, cd_k = ft.fused_fwd(slot, meta, cam, n_ty, n_tx, NEAR, FAR)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p, cd_p = ft._fused_fwd_plain(slot, meta, cam, n_ty, n_tx, NEAR, FAR,
                                      stats=stats)
    torch.cuda.synchronize()
    pms = (time.perf_counter() - t0) * 1e3
    err = float((out_k - out_p).abs().max())
    bit_equal = torch.equal(out_k, out_p)
    cd_equal = torch.equal(cd_k, cd_p)
    walked = walked_slots(meta, cd_k)
    # the projected rows at this camera, with the ok gate folded into the
    # opacity, in the layout footprint_pairs reads
    proj = ft._project8_rows(ft._project_slots(slot, cam), NEAR, FAR)
    proj[6] = proj[6] * proj[7]
    needed = footprint_pairs(proj, meta, cd_k, n_tx)
    del out_p
    log(f"[kernels] fused_fwd: M={b.num_pairs} M_pad={m_pad} tiles="
        f"{n_ty}x{n_tx} walked_slots={walked} walked_pairs={stats['pairs']} "
        f"footprint_pairs={needed} hits={stats['hits']} max_abs_err="
        f"{err:.3e} bit_equal={bit_equal} chunks_done_equal={cd_equal} "
        f"(full size, no crop)")
    if not (bit_equal and cd_equal):
        raise RuntimeError("fused_fwd disagrees with its plain version: "
                           f"err={err} chunks_done_equal={cd_equal}")
    if needed < stats["hits"]:
        raise RuntimeError(f"footprint count {needed} below the gate hits "
                           f"{stats['hits']}")
    # K7a and K7b walk the same chunks with the same boxes
    cull = box_check(proj, meta, cd_k, n_tx)
    del proj
    regs, spill_st, spill_ld = ptxas_usage("fused_walk_kernelILb0E")
    log_cull("fused_fwd", cull, needed, walked, regs, spill_st, spill_ld)
    ms = time_ms(lambda: ft.fused_fwd(slot, meta, cam, n_ty, n_tx, NEAR,
                                      FAR), 20)
    rec_bytes = walked * 5 * 4  # the five record rows a walk reads
    small_bytes = 4 * (cd_k.numel() + meta.numel() + cam.numel())
    entries.append(kernel_entry(
        "fused_fwd", "gsplatloc_tpu_torch/csrc/fused_tracking.cu",
        "gsplatloc_tpu/ops/fused_tracking.py:657", err, ms, pms,
        bound(rec_bytes + out_k.numel() * 4 + small_bytes,
              walked * OPS_FUSED_SLOT + needed * OPS_RAST_EVAL
              + stats["hits"] * OPS_FUSED_FWD_HIT),
        walked_slots=walked, walked_pairs=stats["pairs"],
        footprint_pairs=needed, hits=stats["hits"],
        box_pairs=cull["box_pairs"], gate_hits_outside_box=cull["outside"],
        regs=regs, spill_stores=spill_st, spill_loads=spill_ld))

    # cotangents of depth_acc and alpha from the tracking loss
    d_acc = out_k[0].clone().requires_grad_(True)
    alpha = out_k[1].clone().requires_grad_(True)
    depth = (d_acc / alpha.clamp_min(1e-10))[:H, :W]
    target = torch.as_tensor(pair["tar_depth"], device=dev)
    g_d, g_a = torch.autograd.grad(tracking_loss(depth, target).total,
                                   (d_acc, alpha))
    px_in = torch.stack([out_k[0], out_k[1], g_d, g_a]).contiguous()
    d_k = ft.fused_bwd(slot, meta, cam, cd_k, px_in, n_ty, n_tx, NEAR, FAR)
    d_k2 = ft.fused_bwd(slot, meta, cam, cd_k, px_in, n_ty, n_tx, NEAR, FAR)
    bstats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_p = ft._fused_bwd_plain(slot, meta, cam, cd_k, px_in, n_ty, n_tx, NEAR,
                              FAR, stats=bstats)
    torch.cuda.synchronize()
    pms = (time.perf_counter() - t0) * 1e3
    err = float((d_k - d_p).abs().max())
    rel = err / float(d_p.abs().max())
    repeat = torch.equal(d_k, d_k2)
    log(f"[kernels] fused_bwd: chained_slots={bstats['chained']} "
        f"max_abs_err={err:.3e} max_rel_err={rel:.3e} bitwise_repeatable="
        f"{repeat} d={[float(f'{x:.6e}') for x in d_k.tolist()]}")
    if not (rel <= TOL_BWD_REL and repeat):
        raise RuntimeError(f"fused_bwd disagrees: rel {rel}, repeatable "
                           f"{repeat}")
    regs, spill_st, spill_ld = ptxas_usage("fused_bwd_kernel")
    log_cull("fused_bwd", cull, needed, walked, regs, spill_st, spill_ld)
    ms = time_ms(lambda: ft.fused_bwd(slot, meta, cam, cd_k, px_in, n_ty,
                                      n_tx, NEAR, FAR), 10)
    entries.append(kernel_entry(
        "fused_bwd", "gsplatloc_tpu_torch/csrc/fused_tracking.cu",
        "gsplatloc_tpu/ops/fused_tracking.py:691", err, ms, pms,
        bound(rec_bytes + px_in.numel() * 4 + small_bytes + 12 * 4,
              walked * OPS_FUSED_SLOT + needed * OPS_RAST_EVAL
              + stats["hits"] * OPS_FUSED_BWD_HIT
              + bstats["chained"] * OPS_CHAIN),
        max_rel_err=rel, chained_slots=bstats["chained"],
        footprint_pairs=needed, box_pairs=cull["box_pairs"],
        gate_hits_outside_box=cull["outside"],
        multi_warp_slots=cull["multi_warp_slots"], regs=regs,
        spill_stores=spill_st, spill_loads=spill_ld))

    # the probe at K7a's pose: its chunks are K7a's, and its cull is K7a's
    # (box_check above: no gate hit outside the boxes at this pose)
    cd_same = torch.equal(pcd_k, cd_k)
    slot_c, meta_c = ft.compact_slot_buffer(slot, meta, c_k, pcd_k)
    kept, total = int(meta_c[-1] - meta_c[1]), int(meta[-1] - meta[1])
    out_c, cd_c = ft.fused_fwd(slot_c, meta_c, cam, n_ty, n_tx, NEAR, FAR)
    exact = torch.equal(out_c, out_k)
    regs, spill_st, spill_ld = ptxas_usage("fused_walk_kernelILb1E")
    log(f"[kernels] fused_probe: same_walk_as_fused_fwd={cd_same} kept "
        f"{kept} of {total} slots; compacted fused_fwd bit-equal at the "
        f"probe pose: {exact} (chunks walked {int(cd_c.sum())} of "
        f"{int(cd_k.sum())}); registers {regs}, spill stores/loads "
        f"{spill_st}/{spill_ld} bytes")
    if not (cd_same and exact):
        raise RuntimeError(f"fused_probe: same walk as fused_fwd {cd_same}, "
                           f"compaction exact {exact}")
    ms = time_ms(lambda: ft.fused_probe(slot, meta, cam, n_ty, n_tx, NEAR,
                                        FAR), 20)
    # K7a and K7b on the compacted buffer, as the tracking loop runs them
    # between rebuilds with compaction on; the compacted forward equals the
    # uncompacted one, so px_in holds for it too
    c_fwd_ms = time_ms(lambda: ft.fused_fwd(slot_c, meta_c, cam, n_ty, n_tx,
                                            NEAR, FAR), 20)
    c_bwd_ms = time_ms(lambda: ft.fused_bwd(slot_c, meta_c, cam, cd_c, px_in,
                                            n_ty, n_tx, NEAR, FAR), 10)
    log(f"[kernels] on the compacted buffer: fused_fwd {c_fwd_ms:.4f} ms, "
        f"fused_bwd {c_bwd_ms:.4f} ms")
    entries.append(kernel_entry(
        "fused_probe", "gsplatloc_tpu_torch/csrc/fused_tracking.cu",
        "gsplatloc_tpu/ops/fused_tracking.py:578", probe_err, ms, probe_pms,
        bound(rec_bytes + m_pad * 4 + small_bytes,
              walked * OPS_FUSED_SLOT + needed * OPS_RAST_EVAL
              + stats["hits"] * OPS_FUSED_PROBE_HIT),
        kept_slots=kept, total_slots=total, regs=regs,
        spill_stores=spill_st, spill_loads=spill_ld,
        compacted_fused_fwd_ms=c_fwd_ms, compacted_fused_bwd_ms=c_bwd_ms))
    return entries


def run_main_path(pair, dev, config, backend="fused", mesh=None):
    """Phases 4, 5, 7 and 8: prepare -> scene -> optimize, through the
    entry points. The depth target is rendered by the tracking path's own
    kernel family, as the runner chooses it (the sub-tile walk for the
    K-cover and sub-tile paths, the full-tile walk for subtile=False)."""
    if backend == "fused":
        parser_backend = "subtile" if config.subtile else "fused"
    else:
        parser_backend = backend
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = _assemble_pair(
        pair["tar_rgb"], pair["tar_depth"], pair["tar_c2w"],
        pair["src_rgb"], pair["src_depth"], pair["src_c2w"], pair["K"],
        height=H, width=W, normalize=True, backend=parser_backend)
    scene = scene_from_point_cloud(out["tar_points"], out["colors"],
                                   grid_shape=(H, W))
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    res = optimize_pose(scene, out["tar_c2w"], out["src_depth"], pair["K"],
                        W, H, config=config, backend=backend, mesh=mesh)
    e1.record()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    opt_ms = e0.elapsed_time(e1)
    return dict(out=out, res=res, counts=counts, t_prep=t_prep,
                opt_ms=opt_ms, peak=torch.cuda.max_memory_allocated())


def tracked_pair(pair, dev, config, tag, backend="fused"):
    """Phases 4/5/7/8: the pair tracked twice with `config`; checks
    recovery (eT and eR down 10x), finite results, the second run bit-equal
    to the first. Returns the first run's launch counts and its result."""
    runs = [run_main_path(pair, dev, config, backend) for _ in range(2)]
    r = runs[0]
    res, out = r["res"], r["out"]
    e_t0, e_r0 = pose_errors(out["tar_c2w"], out["src_c2w"])
    e_t, e_r = pose_errors(res.best_pose.to_c2w(), out["src_c2w"])
    counts = r["counts"]
    step_kernel = ("rasterize_bwd" if backend != "fused" else
                   "fused_bwd" if not config.subtile else
                   "kcover_step_fwd" if config.kcover > 0 else "subtile_bwd")
    launched = counts[step_kernel]
    log(f"[{tag}] backend {backend} config subtile={config.subtile} "
        f"kcover={config.kcover} compact={config.compact} "
        f"max_steps={config.max_steps}")
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
    return counts, res


def fulltile_pair(pair, dev, compact):
    """Phase 8a/8b: the pair tracked twice through the full-tile path
    (subtile=False; kcover does not apply there). Every step launches K7a
    and K7b once, the depth target K7a once more; with compaction every
    rebuild (and the initial build) launches K7c once, and the slots kept
    after each compaction are reported. No other kernel runs."""
    kept = []
    compact_fn = ft.compact_slot_buffer

    def recording_compact(slot3d, meta, contrib, chunks_done):
        out = compact_fn(slot3d, meta, contrib, chunks_done)
        kept.append((out[1][-1] - out[1][1], meta[-1] - meta[1]))
        return out

    cfg = TrackingConfig(max_steps=300, subtile=False, compact=compact)
    tag = "fulltile_compact" if compact else "fulltile"
    ft.compact_slot_buffer = recording_compact
    try:
        counts, res = tracked_pair(pair, dev, cfg, tag)
    finally:
        ft.compact_slot_buffer = compact_fn
    # tracked_pair ran the pair twice: the first run's compactions
    first = [(int(a), int(b)) for a, b in kept[:len(kept) // 2]]
    log(f"[{tag}] kept/total slots after each compaction: {first}")
    steps = counts["fused_bwd"]
    probes = counts["fused_probe"]
    want_probes = res.rebuilds + 1 if compact else 0
    others = {k: v for k, v in counts.items()
              if k not in ("fused_fwd", "fused_bwd", "fused_probe") and v}
    if not (steps >= 1 and counts["fused_fwd"] == steps + 1
            and probes == want_probes and len(first) == want_probes
            and not others):
        raise RuntimeError(f"full-tile path launch counts: {counts} "
                           f"(rebuilds {res.rebuilds}, compactions "
                           f"{len(first)})")
    return counts


def _read_run(run_dir):
    """(per-pair records, final summary record, config) of one track run."""
    recs = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    pairs = [r for r in recs if "eT" in r]
    summary = [r for r in recs if "ate_rmse" in r][-1]
    cfg = json.loads((run_dir / "config.json").read_text())
    return pairs, summary, cfg


TRACK_RUNS = (
    ("kcover16", [], ("kcover_step_fwd", "kcover_step_bwd",
                      "kcover_select_records", "project8", "subtile_fwd")),
    ("kcover0", ["--kcover", "0"], ("project8", "subtile_fwd", "subtile_bwd",
                                    "subtile_chain")),
    ("kcover16_serial", ["--no-prefetch"], ()),
    ("kcover0_serial", ["--kcover", "0", "--no-prefetch"], ()),
)
TRACK_RUNS_K12 = (
    ("kcover12", ["--kcover", "12"], ("kcover_step_fwd", "kcover_step_bwd",
                                      "kcover_select", "project8",
                                      "subtile_fwd")),
)
TRACK_RUNS_GENERAL = (
    ("pallas", ["--backend", "pallas"], ("rasterize_fwd", "rasterize_bwd")),
)


def check_serial_equal(tag, prefetched, serial):
    same = prefetched == serial
    log(f"[track:{tag}] serial (no prefetch) per-pair eT bit-equal to the "
        f"prefetched run: {same}")
    if not same:
        raise RuntimeError(f"{tag}: prefetched and serial runs differ: "
                           f"{prefetched} vs {serial}")


def run_sequence_fulltile():
    """Phase 8c: SequenceRunner on the full-tile path (the CLI exposes no
    `subtile` flag, as the reference's does not) on a generated 4-frame
    Synthetic sequence at 1200x680, 300 iterations, exact kNN, with and
    without the prefetch worker. Returns the prefetched run's launch
    counts."""
    from gsplatloc_tpu_torch.tracking.runner import SequenceRunner

    cfg = TrackingConfig(max_steps=300, subtile=False)
    root = Path(tempfile.mkdtemp(prefix="gsl_seq_"))
    results, counts = {}, {}
    try:
        for tag, prefetch in (("fulltile", True), ("fulltile_serial", False)):
            runner = SequenceRunner(
                "Synthetic", "", config=cfg, backend="fused",
                run_dir=root / tag, n_frames=4, height=H, width=W, seed=42)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = runner.train(progress=False, prefetch=prefetch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts[tag] = kernels.launch_counts()
            pairs, summary, rcfg = _read_run(root / tag)
            log(f"[seq:{tag}] parser backend {runner.parser.backend} "
                f"knn_method {rcfg['knn_method']} ATE-RMSE "
                f"{res.ate_rmse * 100:.5f} cm AAE-RMSE {res.aae_rmse:.5f} deg;"
                f" eT/pair [cm] {[round(x * 100, 5) for x in res.eT]} eR/pair"
                f" [deg] {[round(x, 5) for x in res.eR]} steps "
                f"{[int(p['steps']) for p in pairs]} rebuilds "
                f"{[int(p['rebuilds']) for p in pairs]}")
            log(f"[seq:{tag}] wall {wall:.2f} s = {wall / 3:.2f} s per pair; "
                f"stage_s {json.dumps(summary['stage_s'])}")
            log(f"[seq:{tag}] launches {json.dumps(counts[tag])}")
            if (len(res.eT) != 3 or rcfg["knn_method"] != "exact"
                    or not all(np.isfinite(res.eT + res.eR))):
                raise RuntimeError(f"sequence {tag}: {len(res.eT)} pairs, "
                                   f"knn {rcfg['knn_method']}, eT {res.eT}")
            path = {"fused_fwd", "fused_bwd"}
            if (not all(counts[tag][k] >= 1 for k in path)
                    or any(v for k, v in counts[tag].items()
                           if k not in path)):
                raise RuntimeError(f"sequence {tag} launch counts: "
                                   f"{counts[tag]}")
            results[tag] = res.eT
        check_serial_equal("fulltile", results["fulltile"],
                           results["fulltile_serial"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts["fulltile"]


def kcover12_pair(pair, dev):
    """Phase 9a: the pair tracked twice at K=12. Every selection (the
    initial one and each re-selection) runs project8 and the index select
    once; the depth target runs project8 and the sub-tile forward once
    more; the records select never runs."""
    counts, res = tracked_pair(
        pair, dev, TrackingConfig(max_steps=300, kcover=K_INDEX), "kcover12")
    n_sel = res.selects + 1
    if not (counts["kcover_select_records"] == 0
            and counts["kcover_select"] == n_sel
            and counts["project8"] == n_sel + 1
            and counts["subtile_fwd"] == 1
            and counts["kcover_step_fwd"] == counts["kcover_step_bwd"] >= 1):
        raise RuntimeError(f"K=12 path launch counts: {counts} (selects "
                           f"{res.selects} after the first selection)")
    return counts


def route_times(pair, dev):
    """Phase 9b: one re-selection by each route on the phase-3 slot buffer
    (the tracking scene binned at the init pose), at K=12 and K=16:
    build_kcover_buffer's index route (project8 + the index select + the
    row gather) and the records select called directly; at K=12 also the
    index route's three parts."""
    n_ty, n_tx = -(-H // TILE_H), -(-W // TILE_W)
    K = torch.as_tensor(pair["K"], device=dev)
    vm = invert_se3(torch.as_tensor(pair["tar_c2w"], device=dev))
    slot3d, meta, _ = kc.build_kcover_slot_buffer(
        frame_scene(pair, "tar", dev), vm, K, W, H, NEAR, FAR)
    cam = cam_vector(vm, K, W, H).contiguous()
    out = {}
    for k in (K_INDEX, K_COVER):
        out[f"index_route_k{k}"] = time_ms(lambda: kc.build_kcover_buffer(
            slot3d, meta, cam, n_ty, n_tx, NEAR, FAR, k_cover=k,
            via="gather"), 10)
        out[f"records_k{k}"] = time_ms(lambda: kc.select_kcover_records(
            slot3d, meta, cam, n_ty, n_tx, k, NEAR, FAR), 10)
    p8 = fs.project8(slot3d, cam, NEAR, FAR)
    idx = kc.select_kcover(p8, meta, n_ty, n_tx, K_INDEX)
    out["k12_project8"] = time_ms(
        lambda: fs.project8(slot3d, cam, NEAR, FAR), 20)
    out["k12_kcover_select"] = time_ms(
        lambda: kc.select_kcover(p8, meta, n_ty, n_tx, K_INDEX), 20)
    out["k12_gather"] = time_ms(lambda: kc.gather_records(slot3d, idx), 20)
    log(f"[kcover-any-K] one re-selection at the phase-3 pose, ms: "
        f"{json.dumps({k: float(f'{v:.4f}') for k, v in out.items()})}")
    return out


def parity_gates(dev):
    """Phase 9c: the fused families' parity gates on the card at their
    defaults (128x256). subtile_parity and kcover_parity(k_cover=16) must
    pass. kcover_parity(k_cover=12) fails its gate in both packages (K=12
    truncates some cover lists of the box-room scene; the reference's own
    function gives ok=False on the CPU), so the card must give the
    verdict and the numbers of the plain run on the CPU, through the
    index select and never the records select."""
    from gsplatloc_tpu_torch.ops.parity import kcover_parity, subtile_parity

    def show(tag, r, secs):
        log(f"[kcover-any-K] {tag}: ok={r['ok']} d_err {r['d_err']:.3e} "
            f"a_err {r['a_err']:.3e} loss_full {r['loss_full']:.8e} "
            f"loss_sub {r['loss_sub']:.8e} loss_rel {r['loss_rel']:.3e} "
            f"grad_rel {r['grad_rel']:.3e} ({secs:.1f} s)")

    runs = {}
    for tag, fn in (("subtile_parity", lambda d: subtile_parity(device=d)),
                    ("kcover_parity(16)",
                     lambda d: kcover_parity(k_cover=16, device=d)),
                    ("kcover_parity(12)",
                     lambda d: kcover_parity(k_cover=12, device=d))):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        r = fn(dev)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        show(tag, r, time.perf_counter() - t0)
        runs[tag] = (r, counts)
    for tag in ("subtile_parity", "kcover_parity(16)"):
        if not runs[tag][0]["ok"]:
            raise RuntimeError(f"{tag} failed on the card: {runs[tag][0]}")
    r12, c12 = runs["kcover_parity(12)"]
    c16 = runs["kcover_parity(16)"][1]
    if not (c12["kcover_select"] == 1 and c12["kcover_select_records"] == 0
            and c16["kcover_select_records"] == 1
            and c16["kcover_select"] == 0):
        raise RuntimeError(f"parity select routes: K=12 {c12}, K=16 {c16}")
    t0 = time.perf_counter()
    cpu = kcover_parity(k_cover=12, device="cpu")
    show("kcover_parity(12) plain, CPU", cpu, time.perf_counter() - t0)
    scale = max(float(np.abs(cpu["grad_sub"]).max()), 1e-12)
    g_err = float(np.abs(r12["grad_sub"] - cpu["grad_sub"]).max()) / scale
    # the scene, its binning and its sort run on both devices; an ulp of
    # depth may reorder two splats, so the numbers are held to 1e-3 (the
    # CPU tests hold the plain run to the reference's within 1e-4)
    same = (r12["ok"] == cpu["ok"]
            and abs(r12["d_err"] - cpu["d_err"]) <= 1e-3
            and abs(r12["a_err"] - cpu["a_err"]) <= 1e-3
            and abs(r12["loss_sub"] - cpu["loss_sub"])
            <= 1e-4 * abs(cpu["loss_sub"])
            and abs(r12["loss_full"] - cpu["loss_full"])
            <= 1e-4 * abs(cpu["loss_full"])
            and g_err <= 1e-3)
    log(f"[kcover-any-K] kcover_parity(12) card == CPU plain (verdict; "
        f"errors 1e-3; losses 1e-4 rel; gradient 1e-3 of its scale): {same} "
        f"(gradient {g_err:.3e})")
    if not same:
        raise RuntimeError("kcover_parity(12) on the card differs from its "
                           f"plain run: {r12} vs {cpu}")
    return {tag: r["ok"] for tag, (r, _c) in runs.items()}


def run_track_cli(runs):
    """Phases 6 and 7c: `cli track` on a generated 4-frame Synthetic
    sequence at 1200x680, in process, with the kernels' launch counters
    zeroed before and read after each run. Returns {tag: launch counts,
    with the run's pairs and its re-selections summed over them}."""
    from gsplatloc_tpu_torch import cli

    n_frames, n_iters = 4, 300
    root = Path(tempfile.mkdtemp(prefix="gsl_track_"))
    all_counts = {}
    try:
        results = {}
        for tag, extra, want in runs:
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
            all_counts[tag] = dict(counts, selects=sum(
                int(p["selects"]) for p in pairs), pairs=len(pairs))
        for tag in results:
            if tag.endswith("_serial"):
                base = tag[:-len("_serial")]
                check_serial_equal(base, results[base], results[tag])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return all_counts


# phase 10b: (room, frames) — the pairs 0..frames-2 of each room
FIXTURE_RUNS = (("room0", 4), ("room2", 3), ("dense0", 3))
FIXTURE_ATE_RATIO = 3.0  # a prefix's ATE-RMSE against the reference's
FIXTURE_MAX_ET = 5e-4  # metres (0.05 cm), any pair
DEFAULT_PATH = ("kcover_step_fwd", "kcover_step_bwd", "kcover_select_records",
                "project8", "subtile_fwd")


def runner_pair(parser, dev, near_step):
    """A fixture's frames 0 and 1 prepared as the runner prepares them
    (exact kNN, pair assembly with the PCA frame, the tracking scene of
    frame 0 and the depth target's scene of frame 1), as a phase-3 pair
    that carries its scenes and its image size."""
    tar_frame = parser.frame(0)
    hw = tuple(tar_frame.depth.shape)
    knn_tar, knn_src = parser.knn_for_frame(0), parser.knn_for_frame(1)
    data = parser.pair_from_frames(tar_frame, parser.frame(1), knn_src)
    tar = scene_from_point_cloud(data.tar_points, data.colors,
                                 grid_shape=hw, knn_sq_dists=knn_tar,
                                 knn_method="exact", device=dev)
    src = scene_from_point_cloud(data.src_points, data.pixels.reshape(-1, 3),
                                 grid_shape=hw, knn_sq_dists=knn_src,
                                 device=dev)
    return dict(K=parser.K, tar_c2w=data.tar_c2w, near_step=near_step,
                scenes={"tar": tar, "src": src}, hw=hw)


def check_path_kernels(parser, dev, tag):
    """Phases 10a and 11b: the default path's kernels K1-K4 on a fixture's
    pair 0 prepared as the runner prepares it, against their plain
    versions as phase 3 holds them on the box room (K3, K4a and K4b
    bit-equal with every gate hit inside its sub-tile box, K1 and K2
    within TOL_FWD / TOL_BWD_REL). Returns {name: entry}."""
    t0 = time.perf_counter()
    # the fixtures' nearest clutter stands several times closer than the
    # box room's walls (dense0 ~4x): a quarter of phase 3's offset moves
    # it about a pixel (a cover that stale is what the select gate allows)
    pair = runner_pair(parser, dev, near_step=0.25)
    h, w = pair["hw"]
    log(f"[{tag}] pair 0 prepared in {time.perf_counter() - t0:.1f} s "
        f"({w}x{h}; frames waited for, exact kNN, assembly)")
    entries = {e["name"]: e for e in check_kernels(pair, dev, path_only=True)}
    if sorted(entries) != sorted(DEFAULT_PATH):
        raise RuntimeError(f"{tag}: checked {sorted(entries)}")
    for name, e in entries.items():
        e["shape"] = f"{w}x{h}"
        log(f"[{tag}] {w}x{h} {name}: ms {e['ms']:.4f} bound_ms "
            f"{e['bound_ms']:.4f} ({e['bound_by']}) plain_ms "
            f"{e['plain_ms']:.3f} max_abs_err {e['max_abs_err']:.3e}")
    return entries


def run_fixture_track(runs=FIXTURE_RUNS):
    """Phase 10b: `cli track --dataset ReplicaFixture` in process on the
    first pairs of each room, with the reference runs' configuration
    (product defaults, --num-iters 2000; patience 200, warmup 100 and
    early stop are the CLI's), exact kNN; launch counters zeroed before
    and read after each run; each run held pair by pair against the
    reference's records (eval/fixture_compare.py). Raises if a room's
    ATE-RMSE exceeds FIXTURE_ATE_RATIO times the reference's over the same
    pairs, a pair's eT exceeds FIXTURE_MAX_ET, or a pair's clamp count
    differs from the reference's. Returns the summed launch counts."""
    from gsplatloc_tpu_torch import cli
    from gsplatloc_tpu_torch.eval.fixture_compare import compare

    root = Path(tempfile.mkdtemp(prefix="gsl_fixture_"))
    total = {}
    try:
        for room, frames in runs:
            argv = ["track", "--dataset", "ReplicaFixture", "--rooms", room,
                    "--frames", str(frames), "--height", str(H), "--width",
                    str(W), "--num-iters", "2000", "--knn", "exact",
                    "--run-dir", str(root), "--quiet"]
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            c = compare(root / room, room)
            _, summary, cfg = _read_run(root / room)
            p, r = c["port"], c["reference"]
            log(f"[fixture:{room}] argv {' '.join(argv[1:])}")
            for j, i in enumerate(c["pairs"]):
                log(f"[fixture:{room}] pair {i}: port eT "
                    f"{p['eT'][j] * 100:.5f} cm eR {p['eR'][j]:.5f} deg | "
                    f"reference eT {r['eT'][j] * 100:.5f} cm eR "
                    f"{r['eR'][j]:.5f} deg | eT ratio {c['eT_ratio'][j]:.3f}"
                    f" | steps {p['steps'][j]} / {r['steps'][j]} rebuilds "
                    f"{p['rebuilds'][j]} / {r['rebuilds'][j]} selects "
                    f"{p['selects'][j]} / {r['selects'][j]} "
                    f"clamped_scales {p['clamped_scales'][j]} / "
                    f"{r['clamped_scales'][j]} slot_overflow "
                    f"{p['slot_overflow'][j]}")
            log(f"[fixture:{room}] ATE-RMSE {p['ate_rmse'] * 100:.5f} cm "
                f"(reference {r['ate_rmse'] * 100:.5f}, ratio "
                f"{c['ate_ratio']:.3f}) AAE-RMSE {p['aae_rmse']:.5f} deg "
                f"(reference {r['aae_rmse']:.5f}); median steps "
                f"{p['median_steps']:.0f} / {r['median_steps']:.0f}")
            log(f"[fixture:{room}] wall {wall:.2f} s = "
                f"{wall / len(c['pairs']):.2f} s per pair; stage_s "
                f"{json.dumps(summary['stage_s'])}")
            log(f"[fixture:{room}] launches {json.dumps(counts)}")
            if cfg["knn_method"] != "exact" or cfg["max_steps"] != 2000:
                raise RuntimeError(f"fixture {room}: config {cfg}")
            for name in DEFAULT_PATH:
                if counts[name] < 1:
                    raise RuntimeError(f"fixture {room} never launched {name}")
            if counts["kcover_select"]:
                raise RuntimeError(f"fixture {room} launched the index select")
            if not all(np.isfinite(p["eT"] + p["eR"])):
                raise RuntimeError(f"fixture {room}: non-finite eT/eR")
            if not c["ate_ratio"] <= FIXTURE_ATE_RATIO:
                raise RuntimeError(
                    f"fixture {room}: ATE-RMSE {p['ate_rmse']} is "
                    f"{c['ate_ratio']:.3f}x the reference's {r['ate_rmse']}")
            if not max(p["eT"]) <= FIXTURE_MAX_ET:
                raise RuntimeError(f"fixture {room}: a pair's eT above "
                                   f"{FIXTURE_MAX_ET} m: {p['eT']}")
            if not c["clamped_equal"]:
                raise RuntimeError(
                    f"fixture {room}: clamped_scales {p['clamped_scales']},"
                    f" the reference's {r['clamped_scales']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


# phase 11: the TUM fixture scenes, written by the port at the suite's
# arguments (data/tum_fixture.py); (scene, pairs of the prefix tracked)
TUM_RUNS = (("freiburg1_desk", 4), ("freiburg2_stress", 4))
TUM_PAIRS = {"freiburg1_desk": 33}  # the reference's pairs, where reproduced


def write_tum_scenes(root):
    """Phase 11a: both TUM fixture scenes written by the port (no OpenCV)
    at the suite's arguments; desk must associate the reference's pairs."""
    from gsplatloc_tpu_torch.data.datasets import TUM
    from gsplatloc_tpu_torch.data.tum_fixture import SUITE, write_tum_fixture

    out = {}
    for scene, kw in SUITE.items():
        t0 = time.perf_counter()
        write_tum_fixture(root, scene=scene, **kw)
        out[scene] = len(TUM(scene, root=root))
        log(f"[tum] wrote {scene} ({json.dumps(kw)}) in "
            f"{time.perf_counter() - t0:.1f} s: {out[scene]} frames "
            f"associated, {out[scene] - 1} pairs")
    for scene, n_pairs in TUM_PAIRS.items():
        if out[scene] - 1 != n_pairs:
            raise RuntimeError(f"tum {scene}: {out[scene] - 1} pairs "
                               f"associated, the reference's {n_pairs}")


def run_tum_track(root):
    """Phase 11c: `cli track --dataset TUM` in process on a prefix of each
    scene with the reference runs' configuration (product defaults,
    --backend fused; exact kNN as they ran), launch counters zeroed
    before and read after each run, each pair printed beside the
    reference's record. Raises if a prefix's ATE-RMSE exceeds
    FIXTURE_ATE_RATIO times the reference's over the same pairs, or a
    pair's clamp count differs from the reference's; a scene whose
    per-pair record the writer does not reproduce (stress) is held to the
    reference's whole-run ATE-RMSE. Returns the summed launch counts."""
    from gsplatloc_tpu_torch import cli
    from gsplatloc_tpu_torch.data.tum_fixture import PER_PAIR
    from gsplatloc_tpu_torch.eval.fixture_compare import (
        compare, compare_class,
    )

    runs = Path(tempfile.mkdtemp(prefix="gsl_tum_runs_"))
    total = {}
    try:
        for scene, n_pairs in TUM_RUNS:
            argv = ["track", "--dataset", "TUM", "--data-root", str(root),
                    "--rooms", scene, "--backend", "fused", "--knn", "exact",
                    "--max-pairs", str(n_pairs), "--run-dir", str(runs),
                    "--quiet"]
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            _, summary, cfg = _read_run(runs / scene)
            log(f"[tum:{scene}] argv {' '.join(argv[1:])}")
            if scene in PER_PAIR:
                c = compare(runs / scene, scene)
                p, r = c["port"], c["reference"]
                for j, i in enumerate(c["pairs"]):
                    log(f"[tum:{scene}] pair {i}: port eT "
                        f"{p['eT'][j] * 100:.5f} cm eR {p['eR'][j]:.5f} deg"
                        f" | reference eT {r['eT'][j] * 100:.5f} cm eR "
                        f"{r['eR'][j]:.5f} deg | eT ratio "
                        f"{c['eT_ratio'][j]:.3f} | steps {p['steps'][j]} / "
                        f"{r['steps'][j]} clamped_scales "
                        f"{p['clamped_scales'][j]} / "
                        f"{r['clamped_scales'][j]}")
                if not c["clamped_equal"]:
                    raise RuntimeError(
                        f"tum {scene}: clamped_scales {p['clamped_scales']}, "
                        f"the reference's {r['clamped_scales']}")
            else:
                c = compare_class(runs / scene, scene)
                p, r = c["port"], c["reference"]
                log(f"[tum:{scene}] per pair eT cm "
                    f"{[round(x * 100, 5) for x in p['eT']]} steps "
                    f"{p['steps']}; held to the reference's whole run "
                    f"({len(r['eT'])} pairs): its arguments are not "
                    f"reconstructed")
            ratio = c["ate_ratio"]
            log(f"[tum:{scene}] ATE-RMSE {p['ate_rmse'] * 100:.5f} cm "
                f"(reference {r['ate_rmse'] * 100:.5f}, ratio {ratio:.3f}) "
                f"AAE-RMSE {p['aae_rmse']:.5f} deg; wall {wall:.2f} s = "
                f"{wall / n_pairs:.2f} s per pair; stage_s "
                f"{json.dumps(summary['stage_s'])}")
            log(f"[tum:{scene}] launches {json.dumps(counts)}")
            if cfg["knn_method"] != "exact" or cfg["dataset"] != "TUM":
                raise RuntimeError(f"tum {scene}: config {cfg}")
            for name in DEFAULT_PATH:
                if counts[name] < 1:
                    raise RuntimeError(f"tum {scene} never launched {name}")
            if not all(np.isfinite(p["eT"] + p["eR"])):
                raise RuntimeError(f"tum {scene}: non-finite eT/eR")
            if not ratio <= FIXTURE_ATE_RATIO:
                raise RuntimeError(f"tum {scene}: ATE-RMSE {p['ate_rmse']} "
                                   f"is {ratio:.3f}x the reference's")
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    return total


# phase 12: `cli icp` on room0's first ICP_FRAMES frames
ICP_METHODS = ("ICP", "PLANE_ICP", "GICP", "COLORED_ICP", "HYBRID")
ICP_FRAMES = 5
ICP_SAME_DEPTH = ("ICP", "PLANE_ICP", "GICP")  # see the reference's depth
ICP_ET_TOL = 1e-6  # metres, |eT - the reference's| per pair, those three
ICP_ATE_RATIO = 2.0


def run_icp_cli():
    """Phase 12: `cli icp --dataset ReplicaFixture --rooms room0` with the
    five methods on the first ICP_FRAMES frames, in process (the command
    of the reference's records but for --max-pairs), each pair beside the
    reference's record. Raises if ICP, PLANE_ICP or GICP has a pair's eT
    off the reference's by more than ICP_ET_TOL, a method's ATE-RMSE is
    above ICP_ATE_RATIO times the reference's over the same pairs, or
    HYBRID did not run on the card."""
    from gsplatloc_tpu_torch import cli
    from gsplatloc_tpu_torch.eval.fixture_compare import compare_icp

    runs = Path(tempfile.mkdtemp(prefix="gsl_icp_"))
    try:
        common = ["--dataset", "ReplicaFixture", "--rooms", "room0",
                  "--max-pairs", str(ICP_FRAMES), "--run-dir", str(runs)]
        # the point-cloud methods first, then HYBRID alone, so that the
        # device memory it allocates is measured around its own run
        t0 = time.perf_counter()
        cli.main(["icp", "--methods", *ICP_METHODS[:-1], *common])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cli.main(["icp", "--methods", "HYBRID", *common])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hybrid_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
        log(f"[icp] {' '.join(common)} --methods {' '.join(ICP_METHODS)}:"
            f" {wall:.1f} s; HYBRID's own device peak {hybrid_mib:.0f} MiB")
        for method in ICP_METHODS:
            run = runs / f"room0_{method}"
            c = compare_icp(run, "room0", method)
            p, r = c["port"], c["reference"]
            recs = [json.loads(x) for x in
                    (run / "metrics.jsonl").read_text().splitlines()]
            cfg = json.loads((run / "config.json").read_text())
            diffs = [abs(a - b) for a, b in zip(p["eT"], r["eT"])]
            log(f"[icp:{method}] eT cm port "
                f"{[round(x * 100, 5) for x in p['eT']]} reference "
                f"{[round(x * 100, 5) for x in r['eT']]} max |diff| "
                f"{max(diffs) * 100:.2e} cm; ATE-RMSE "
                f"{p['ate_rmse'] * 100:.5f} cm (reference "
                f"{r['ate_rmse'] * 100:.5f}, ratio {c['ate_ratio']:.4f}) "
                f"AAE-RMSE {p['aae_rmse']:.5f} deg (reference "
                f"{r['aae_rmse']:.5f}); {recs[-1]['ts'] - recs[0]['ts']:.1f}"
                f" s from the first pair's record; device {cfg['device']}")
            if len(c["pairs"]) != ICP_FRAMES - 1:
                raise RuntimeError(f"icp {method}: {len(c['pairs'])} pairs")
            if not all(np.isfinite(p["eT"] + p["eR"])):
                raise RuntimeError(f"icp {method}: non-finite eT/eR")
            if method in ICP_SAME_DEPTH and not max(diffs) <= ICP_ET_TOL:
                raise RuntimeError(f"icp {method}: a pair's eT is "
                                   f"{max(diffs)} m off the reference's")
            if not c["ate_ratio"] <= ICP_ATE_RATIO:
                raise RuntimeError(f"icp {method}: ATE-RMSE ratio "
                                   f"{c['ate_ratio']:.3f}")
            if method == "HYBRID" and not cfg["device"].startswith("cuda"):
                raise RuntimeError(f"icp HYBRID ran on {cfg['device']}")
        # the dense odometry's (H, W, 6) Jacobians at 1200x680 are ~20 MiB
        # each, and HYBRID back-projects no cloud
        if not hybrid_mib >= 100:
            raise RuntimeError(f"icp: HYBRID allocated {hybrid_mib:.0f} MiB "
                               "on the card; its odometry did not run there")
    finally:
        shutil.rmtree(runs, ignore_errors=True)


# phase 13: `cli render` — at full width, and at the JAX package's defaults
# beside its record (eval/render_reference.json)
RENDER_ARGV = ["render", "--device", "cuda", "--dataset", "Synthetic",
               "--path", "spline", "--n-views", "24"]
RENDER_FULL = ["--width", str(W), "--height", str(H)]
RENDER_DEFAULTS = ["--width", "320", "--height", "240"]
VIEWER_WH = (640, 360)


def render_cli(argv, out, on_view=None):
    """`cli render` in process into `out`, the launch counters zeroed just
    before and read just after; on_view(render, alpha) sees every view as
    the command rendered it. Returns (views written, counts, wall s)."""
    from gsplatloc_tpu_torch import cli

    view = cli.render_view

    def watched(*a, **k):
        render, alpha = view(*a, **k)
        on_view(render, alpha)
        return render, alpha

    if on_view is not None:
        cli.render_view = watched
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        cli.main(argv + ["--out", str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    finally:
        cli.render_view = view
    n = len(list(Path(out).glob("view_*.png")))
    log(f"[render] argv {' '.join(argv[1:])}: {n} views in {wall:.2f} s; "
        f"launches {json.dumps({k: v for k, v in counts.items() if v})}")
    others = {k: v for k, v in counts.items() if k != "rasterize_fwd" and v}
    if counts["rasterize_fwd"] != n or others or n < 2:
        raise RuntimeError(f"render: {n} views, launches {counts}")
    return n, counts, wall


def pack_view(scene, K, c2w, dev):
    """Projection, SH colours and pack_slots of one view, as rasterize
    runs them: (packed, meta, binning)."""
    from gsplatloc_tpu_torch.ops.projection import project_gaussians
    from gsplatloc_tpu_torch.ops.rasterize import _view_dirs
    from gsplatloc_tpu_torch.ops.sh import eval_sh

    vm = invert_se3(torch.as_tensor(np.asarray(c2w, np.float32), device=dev))
    with torch.no_grad():
        proj = project_gaussians(scene.means, scene.quats, scene.scales, vm,
                                 K, W, H)
        colors = eval_sh(1, scene.sh_coeffs, _view_dirs(scene.means, vm))
        return rt.pack_slots(proj.mean2d, proj.conic, proj.depth,
                             scene.opacities, colors, proj.valid,
                             proj.radius, W, H)


def render_split(scene, K, path, dev):
    """Per view of the path, the render's two device parts timed apart
    with time_block: projection + SH + pack_slots, and K6a."""
    from gsplatloc_tpu_torch.utils import profiling

    for c2w in path:
        with profiling.time_block("split/pack") as tb:
            packed, meta, b = tb.watch(pack_view(scene, K, c2w, dev))
        with profiling.time_block("split/k6a") as tb:
            tb.watch(rt.rasterize_fwd(packed, meta, b.n_tiles_y,
                                      b.n_tiles_x))
    return {k: profiling.timer_stats(f"split/{k}") for k in ("pack", "k6a")}


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def check_viewer(scene, K, dev):
    """Phase 13d: the live viewer on the card over the full-width scene;
    its /render PNG against a direct render of its camera."""
    import urllib.request

    from gsplatloc_tpu_torch.data.png import decode
    from gsplatloc_tpu_torch.eval.viewer import LiveViewer
    from gsplatloc_tpu_torch.ops.rasterize import rasterize

    vw, vh = VIEWER_WH
    viewer = LiveViewer(K, vw, vh, port=free_port(), backend="pallas",
                        device=dev).start()
    base = f"http://127.0.0.1:{viewer.port}"
    query = "tx=0&ty=0&tz=-1&rx=0&ry=0"
    try:
        viewer.set_scene(scene)
        viewer.update(step=1, rays_per_sec=0.0)
        page = urllib.request.urlopen(base + "/", timeout=60).read()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        resp = urllib.request.urlopen(f"{base}/render?{query}", timeout=300)
        body = resp.read()
        secs = time.perf_counter() - t0
        launches = kernels.launch_counts()["rasterize_fwd"]
        stats = json.loads(urllib.request.urlopen(base + "/stats",
                                                  timeout=60).read())
    finally:
        viewer.stop()
    served = decode(body)[..., ::-1]
    c2w, Kv = viewer.camera({k: [v] for k, v in
                             (kv.split("=") for kv in query.split("&"))})
    with torch.no_grad():
        render, _ = rasterize(
            scene.means, scene.quats, scene.scales, scene.opacities,
            scene.sh_coeffs, invert_se3(torch.as_tensor(c2w, device=dev)),
            torch.as_tensor(Kv, device=dev), vw, vh, sh_degree=1,
            render_mode="RGB+ED", backend="pallas")
    direct = (np.clip(render[..., :3].cpu().numpy(), 0, 1) * 255).astype(
        np.uint8)
    equal = np.array_equal(served, direct)
    log(f"[render] viewer {vw}x{vh}: / {len(page)} bytes, /render "
        f"{resp.headers['Content-Type']} {len(body)} bytes in {secs:.3f} s "
        f"(K6a launches {launches}), /stats {json.dumps(stats)}; PNG equal "
        f"to a direct render: {equal}, lit pixels "
        f"{int((direct.max(-1) > 0).sum())}")
    if not (equal and resp.headers["Content-Type"] == "image/png"
            and launches == 1 and b"<img" in page and direct.max() > 0
            and stats["step"] == 1):
        raise RuntimeError("viewer: its frame is not the direct render "
                           f"(equal {equal}, launches {launches})")


def check_metrics(scene, K, frame, dev):
    """Phase 13e: psnr, ssim and lpips (random parameters, seed 0) between
    the render at the scene's own keyframe pose and that frame's RGB."""
    from gsplatloc_tpu_torch import cli
    from gsplatloc_tpu_torch.eval.lpips import lpips, random_lpips_params
    from gsplatloc_tpu_torch.ops.filters import psnr, ssim

    render, _ = cli.render_view(scene, K, frame.c2w, W, H)
    rgb = render[..., :3].clamp(0, 1)
    gt = torch.as_tensor(frame.rgb, dtype=torch.float32, device=dev) / 255.0
    with torch.no_grad():
        t0 = time.perf_counter()
        vals = {"psnr": float(psnr(rgb, gt)), "ssim": float(ssim(rgb, gt)),
                "lpips": float(lpips(rgb, gt, random_lpips_params(0, dev)))}
        secs = time.perf_counter() - t0
    log(f"[render] keyframe view against its frame's RGB ({W}x{H}): "
        f"{json.dumps(vals)} ({secs:.2f} s)")
    if not all(np.isfinite(v) for v in vals.values()) or vals["psnr"] < 10:
        raise RuntimeError(f"render metrics: {vals}")


def check_trace(scene, K, c2w, dev):
    """Phase 13f: profile_trace around one full-width view; the trace must
    name K6a's kernel."""
    from gsplatloc_tpu_torch import cli
    from gsplatloc_tpu_torch.utils.profiling import TRACE_FILE, profile_trace

    root = Path(tempfile.mkdtemp(prefix="gsl_trace_"))
    try:
        with profile_trace(root, device=dev):
            cli.render_view(scene, K, c2w, W, H)
        events = json.loads((root / TRACE_FILE).read_text())["traceEvents"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    device_ops = sorted((e for e in events if e.get("cat") == "kernel"
                         or e.get("cat") == "gpu_memcpy"),
                        key=lambda e: -e.get("dur", 0))
    k6a = [e for e in device_ops if "rasterize_fwd_kernel" in e["name"]]
    top = [(e["name"][:60], round(e.get("dur", 0) / 1e3, 3))
           for e in device_ops[:3]]
    log(f"[render] trace of one view: {len(device_ops)} device operations, "
        f"K6a {len(k6a)} ({sum(e.get('dur', 0) for e in k6a) / 1e3:.3f} ms), "
        f"longest three (name, ms): {top}")
    if not k6a:
        raise RuntimeError("the trace names no rasterize_fwd_kernel")


def run_render(dev):
    """Phase 13: `cli render` on the card. Returns K6a's novel-view entry
    for the kernels line."""
    from gsplatloc_tpu_torch import cli
    from gsplatloc_tpu_torch.data.png import imread
    from gsplatloc_tpu_torch.eval import render_compare
    from gsplatloc_tpu_torch.utils import profiling

    root = Path(tempfile.mkdtemp(prefix="gsl_render_"))
    try:
        # (a) full width
        argv = RENDER_ARGV + RENDER_FULL
        profiling.reset_timers()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        n, counts, wall = render_cli(argv, root / "full")
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        split = {k: profiling.timer_stats(f"render/{k}")
                 for k in ("data", "scene", "view", "panel")}
        panel = imread(root / "full" / f"view_{n // 2:04d}.png")
        lit = float((panel.max(-1) > 0).mean())
        log(f"[render] (a) {W}x{H}: {n} views, wall {wall:.2f} s "
            f"({wall / n * 1e3:.1f} ms a view), peak device memory of its run "
            f"{peak:.0f} MiB; time_block ms: " + "; ".join(
                f"{k} {v['mean_s'] * 1e3:.2f} mean, {v['min_s'] * 1e3:.2f} "
                f"min x {v['count']}" for k, v in split.items()))
        log(f"[render] (a) panel {n // 2}: shape {panel.shape}, lit share "
            f"{lit:.4f}, mean {float(panel.mean()):.2f}")
        if panel.shape != (H, 2 * W, 3) or lit < 0.5 or panel.std() < 5:
            raise RuntimeError(f"render: panel {panel.shape}, lit {lit}")
        args = cli.build_parser().parse_args(argv + ["--out", str(root)])
        frame, path = cli.flythrough_path(args)
        scene, K = cli.frame_scene(frame, dev)
        profiling.reset_timers()
        parts = render_split(scene, K, path, dev)
        log(f"[render] (a) the view's device parts, time_block ms over "
            f"{n} views (mean / min): projection + SH + pack_slots "
            f"{parts['pack']['mean_s'] * 1e3:.2f} / "
            f"{parts['pack']['min_s'] * 1e3:.2f}, K6a "
            f"{parts['k6a']['mean_s'] * 1e3:.3f} / "
            f"{parts['k6a']['min_s'] * 1e3:.3f}")
        torch.cuda.empty_cache()

        # (b) K6a on the middle view, between keyframes
        mid = n // 2
        packed, meta, b = pack_view(scene, K, path[mid], dev)
        fwd = check_raster_fwd(packed, meta, b, "rasterize_fwd novel view",
                               f"(path view {mid} of {n}, {W}x{H})",
                               shape=f"{W}x{H} novel view")
        entry = fwd["entry"]
        entry["launches"] = counts["rasterize_fwd"]
        del packed, meta, b, fwd
        torch.cuda.empty_cache()

        # (d) the viewer, (e) the metrics, (f) a trace, on the same scene
        check_viewer(scene, K, dev)
        check_metrics(scene, K, frame, dev)
        check_trace(scene, K, path[mid], dev)
        del scene
        torch.cuda.empty_cache()

        # (c) the JAX package's defaults, held against its record
        summaries = []
        render_cli(RENDER_ARGV + RENDER_DEFAULTS, root / "defaults",
                   on_view=lambda r, a: summaries.append(
                       render_compare.summarize(r.cpu().numpy(),
                                                a.cpu().numpy())))
        res = render_compare.compare(render_compare.load_reference(),
                                     summaries)
        log(f"[render] (c) 320x240 against the JAX package's record: "
            f"{res['views']} views, largest difference per channel "
            f"(ED relative) {json.dumps(res.get('max_diff'))} at "
            f"{json.dumps(res.get('where'))}; gate {render_compare.TOL}: "
            f"ok={res['ok']}")
        if not res["ok"]:
            raise RuntimeError(f"render against the record: {res}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return entry


# ---------------------------------------------------------------------------
# phase 14: tile-row bands (parallel/) on this card
# ---------------------------------------------------------------------------

MESH_BANDS = 4  # 1200x680: 43 tile rows padded to 44, 11 a band
MESH_SHORT_STEPS = 60  # (c): K=12 and the sub-tile path
MESH_TIME_STEPS = 20  # (c) the general path, timed only; (d)
# (c): a band run's eT / eR against the single-device run's: at most 2x,
# with floors at which both sit at the metrics' resolution
MESH_CLASS = 2.0
MESH_ET_FLOOR, MESH_ER_FLOOR = 1e-5, 5e-3  # m, deg
MESH_ROOMS = [f"room{i}" for i in range(5)]  # (d): shard_scenes


def band_mesh(dev, n=MESH_BANDS):
    """n bands on this one card (each band its own kernel launches)."""
    from gsplatloc_tpu_torch.parallel import make_tile_mesh

    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return make_tile_mesh(devices=[f"cuda:{idx}"] * n)


def check_band_step(pair, dev, mesh):
    """Phase 14a: K1 and K2 on the last band (row0_px = its first global
    pixel row) against their plain versions: K1 bit-equal, and its rows
    bit-equal to the same rows of the whole image's K1; K2 within
    TOL_BWD_REL. Both re-timed at row0_px=0 on the whole image (PERF.md
    §6's shapes) and on the band. Returns their kernels-line entries."""
    K = torch.as_tensor(pair["K"], device=dev)
    vm = invert_se3(torch.as_tensor(pair["tar_c2w"], device=dev))
    n_ty, n_tx = -(-H // TILE_H), -(-W // TILE_W)
    d = mesh.shape["tiles"]
    rows_per = -(-n_ty // d)
    scene = frame_scene(pair, "tar", dev)
    slot3d, meta, _ = kc.build_kcover_slot_buffer(scene, vm, K, W, H, NEAR,
                                                  FAR)
    del scene
    cam = cam_vector(vm, K, W, H).contiguous()
    kb = kc.build_kcover_buffer(slot3d, meta, cam, n_ty, n_tx, NEAR, FAR,
                                k_cover=K_COVER)
    bands = kc.build_kcover_buffer(slot3d, meta, cam, n_ty, n_tx, NEAR, FAR,
                                   k_cover=K_COVER, mesh=mesh)
    del slot3d
    m_out, m_band = kb.shape[2], bands[0].shape[2]
    whole = torch.cat(bands, dim=2)
    cut_equal = (torch.equal(whole[:, :, :m_out], kb)
                 and not bool(whole[:, :, m_out:].any()))
    del whole
    b = d - 1
    row0 = float(b * rows_per * TILE_H)
    kb_b = bands[b]
    cam_s = cam_vector(near_viewmat(pair, dev), K, W, H).contiguous()
    f_k = kc.kcover_step_fwd(kb_b, cam_s, rows_per, n_tx, NEAR, FAR, row0)
    f_p = kc._kcover_step_fwd_plain(kb_b, cam_s, rows_per, n_tx, NEAR, FAR,
                                    row0)
    f_w = kc.kcover_step_fwd(kb, cam_s, n_ty, n_tx, NEAR, FAR)
    inside = m_out - b * m_band  # the band's pixels inside the image
    err = float((f_k - f_p).abs().max())
    bit_equal = torch.equal(f_k, f_p)
    rows_equal = torch.equal(f_k[:, :inside], f_w[:, b * m_band:])
    log(f"[mesh] K3 per band: the {d} band buffers are the whole image's "
        f"cut at the band boundaries (padded row uncovered): {cut_equal}")
    log(f"[mesh] kcover_step_fwd at row0_px={row0:.0f} (band {b}, "
        f"{rows_per} tile rows): max_abs_err={err:.3e} bit_equal="
        f"{bit_equal}; rows bit-equal to the whole image's: {rows_equal}")
    if not (cut_equal and bit_equal and rows_equal):
        raise RuntimeError("K1 at a band's row0_px disagrees: "
                           f"buffer cut {cut_equal}, plain {bit_equal} "
                           f"(err {err}), whole-image rows {rows_equal}")

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    g_d = torch.randn(m_band, generator=gen).to(dev)
    g_a = torch.randn(m_band, generator=gen).to(dev)
    b_k = kc.kcover_step_bwd(kb_b, cam_s, rows_per, n_tx, NEAR, FAR, g_d,
                             g_a, f_k, row0)
    b_p = kc._kcover_step_bwd_plain(kb_b, cam_s, rows_per, n_tx, NEAR, FAR,
                                    g_d, g_a, f_k, row0)
    torch.cuda.synchronize()
    err_b = float((b_k - b_p).abs().max())
    rel = err_b / float(b_p.abs().max())
    log(f"[mesh] kcover_step_bwd at row0_px={row0:.0f}: max_abs_err="
        f"{err_b:.3e} max_rel_err={rel:.3e}")
    if not rel <= TOL_BWD_REL:
        raise RuntimeError(f"K2 at a band's row0_px disagrees: rel {rel}")

    # times: the whole image at row0_px=0, as phase 3 times them, and the
    # band at its row0_px
    g_dw = torch.randn(m_out, generator=gen).to(dev)
    g_aw = torch.randn(m_out, generator=gen).to(dev)
    ms_f = time_ms(lambda: kc.kcover_step_fwd(
        kb, cam_s, n_ty, n_tx, NEAR, FAR, 0.0), 50)
    ms_b = time_ms(lambda: kc.kcover_step_bwd(
        kb, cam_s, n_ty, n_tx, NEAR, FAR, g_dw, g_aw, f_w, 0.0), 50)
    ms_fb = time_ms(lambda: kc.kcover_step_fwd(
        kb_b, cam_s, rows_per, n_tx, NEAR, FAR, row0), 50)
    ms_bb = time_ms(lambda: kc.kcover_step_bwd(
        kb_b, cam_s, rows_per, n_tx, NEAR, FAR, g_d, g_a, f_k, row0), 50)
    pms_f = time_ms(lambda: kc._kcover_step_fwd_plain(
        kb, cam_s, n_ty, n_tx, NEAR, FAR), 3, warm=1)
    pms_b = time_ms(lambda: kc._kcover_step_bwd_plain(
        kb, cam_s, n_ty, n_tx, NEAR, FAR, g_dw, g_aw, f_w), 3, warm=1)
    bnd_f, bnd_b, needed = step_bounds(kb, cam_s, n_ty, n_tx)
    log(f"[mesh] whole image at row0_px=0: kcover_step_fwd {ms_f:.4f} ms, "
        f"kcover_step_bwd {ms_b:.4f} ms (PERF.md §6: 0.1566 / 0.2540); the "
        f"band at row0_px={row0:.0f}: {ms_fb:.4f} / {ms_bb:.4f} ms")
    src = "gsplatloc_tpu_torch/csrc/kcover_step.cu"
    return [
        kernel_entry("kcover_step_fwd", src, "gsplatloc_tpu/ops/kcover.py:940",
                     err, ms_f, pms_f, bnd_f, row0_px=row0, band_ms=ms_fb, bit_equal=bit_equal,
                     band_rows_equal_whole_image=rows_equal,
                     records_needed=needed),
        kernel_entry("kcover_step_bwd", src, "gsplatloc_tpu/ops/kcover.py:964",
                     err_b, ms_b, pms_b, bnd_b, row0_px=row0, band_ms=ms_bb, max_rel_err=rel),
    ]


def check_band_paths(pair, dev, mesh, tag):
    """Phase 14b: each tracking path's render at the near pose over the
    mesh against one device: depth and alpha bit for bit, the viewmat
    gradient of a depth + alpha loss within rtol 1e-4 / atol 1e-7 (the
    band partials summed in band order). K-cover 16 through the records
    select per band; sub-tile; full-tile; general (backend "pallas")."""
    from gsplatloc_tpu_torch.ops.rasterize import rasterize

    K = torch.as_tensor(pair["K"], device=dev)
    vm0 = invert_se3(torch.as_tensor(pair["tar_c2w"], device=dev))
    vm_s = near_viewmat(pair, dev)
    n_ty, n_tx = -(-H // TILE_H), -(-W // TILE_W)
    scene = frame_scene(pair, "tar", dev)
    cam0 = cam_vector(vm0, K, W, H).contiguous()

    def kcover_path():
        slot3d, meta, _ = kc.build_kcover_slot_buffer(scene, vm0, K, W, H,
                                                      NEAR, FAR)
        bufs = {m is None: kc.build_kcover_buffer(
            slot3d, meta, cam0, n_ty, n_tx, NEAR, FAR, k_cover=K_COVER,
            mesh=m) for m in (None, mesh)}
        return lambda vm, m: kc.render_tracking_depth_kcover(
            vm, K, W, H, bufs[m is None], NEAR, FAR, mesh=m)

    def subtile_path():
        slot3d, meta, _ = fs.build_subtile_slot_buffer(scene, vm0, K, W, H,
                                                       NEAR, FAR)
        return lambda vm, m: fs.render_tracking_depth_subtile(
            vm, K, W, H, slot3d, meta, NEAR, FAR, mesh=m)

    def fulltile_path():
        slot3d, meta, _ = ft.build_slot_buffer(scene, vm0, K, W, H, NEAR,
                                               FAR)
        return lambda vm, m: ft.render_tracking_depth(
            vm, K, W, H, slot3d, meta, NEAR, FAR, mesh=m)

    def general_path():
        def render(vm, m):
            r, a = rasterize(scene.means, scene.quats, scene.scales,
                             scene.opacities, scene.sh_coeffs, vm, K, W, H,
                             sh_degree=1, render_mode="RGB+ED",
                             backend="pallas", mesh=m)
            return r[..., 3], a
        return render

    for name, make in (("kcover16", kcover_path), ("subtile", subtile_path),
                       ("fulltile", fulltile_path),
                       ("general", general_path)):
        render = make()
        # warm-up: a path's first forward + backward pays for its first
        # launches, so each of the two timed below is a later call
        vm = vm_s.clone().requires_grad_(True)
        dd, aa = render(vm, None)
        torch.autograd.grad(torch.mean(dd) + torch.mean(aa), vm)
        out = {}
        for m in (None, mesh):
            vm = vm_s.clone().requires_grad_(True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dd, aa = render(vm, m)
            if m is None:
                target = dd.detach() * 1.01
            loss = torch.mean((dd - target) ** 2) + 0.05 * torch.mean(aa)
            g = torch.autograd.grad(loss, vm)[0]
            torch.cuda.synchronize()
            out[m is None] = (dd.detach(), aa.detach(), g,
                              (time.perf_counter() - t0) * 1e3)
        (d1, a1, g1, t1), (d2, a2, g2, t2) = out[True], out[False]
        equal = torch.equal(d1, d2) and torch.equal(a1, a2)
        d_err = float(torch.nan_to_num(d1 - d2).abs().max())
        a_err = float((a1 - a2).abs().max())
        g_err = float((g1 - g2).abs().max())
        g_rel = g_err / float(g1.abs().max())
        g_ok = bool(torch.allclose(g2, g1, rtol=1e-4, atol=1e-7))
        log(f"[mesh:{tag}] {name}: forward bit-equal {equal} (depth "
            f"{d_err:.3e}, alpha {a_err:.3e}); viewmat gradient max err "
            f"{g_err:.3e} ({g_rel:.3e} of its largest), within rtol 1e-4 / "
            f"atol 1e-7: {g_ok}; forward + backward {t1:.1f} ms on one "
            f"device, {t2:.1f} ms in {mesh.shape['tiles']} bands")
        if not equal:
            raise RuntimeError(
                f"{name}: the banded forward differs from one device's "
                f"(depth {d_err}, alpha {a_err}): every band runs the "
                "single-device walk on its rows, so a difference is a "
                "fault of the band split (row offset, starts, padding)")
        if not g_ok:
            raise RuntimeError(f"{name}: banded gradient off by {g_err}")
        del render, out, d1, a1, d2, a2
        torch.cuda.empty_cache()


def mesh_pair(pair, dev, mesh, config, tag, backend="fused", runs=2):
    """Phase 14c: the pair tracked on one device once and `runs` times over
    the mesh: the band runs bit-equal to each other, their eT / eR within
    MESH_CLASS of the single-device run's (or at its floors), the time per
    launched step beside the single-device run's. Returns the first band
    run's launch counts and the largest peak device memory of the
    runs."""
    single = run_main_path(pair, dev, config, backend)
    banded = [run_main_path(pair, dev, config, backend, mesh=mesh)
              for _ in range(runs)]
    step_kernel = ("rasterize_bwd" if backend != "fused" else
                   "fused_bwd" if not config.subtile else
                   "kcover_step_fwd" if config.kcover > 0 else "subtile_bwd")
    d = mesh.shape["tiles"]
    src = single["out"]["src_c2w"]
    e1 = pose_errors(single["res"].best_pose.to_c2w(), src)
    r = banded[0]
    e2 = pose_errors(r["res"].best_pose.to_c2w(), src)
    l1 = single["counts"][step_kernel]
    l2 = r["counts"][step_kernel] // d
    log(f"[mesh:{tag}] one device: eT {e1[0] * 100:.4f} cm eR {e1[1]:.4f} "
        f"deg, steps_run {single['res'].steps_run}, {single['opt_ms']:.1f} "
        f"ms = {single['opt_ms'] / max(l1, 1):.3f} ms per launched step "
        f"({l1} launched), {single['peak'] / 2**20:.0f} MiB")
    log(f"[mesh:{tag}] {d} bands: eT {e2[0] * 100:.4f} cm eR {e2[1]:.4f} "
        f"deg, steps_run {r['res'].steps_run} rebuilds {r['res'].rebuilds} "
        f"selects {r['res'].selects}, {r['opt_ms']:.1f} ms = "
        f"{r['opt_ms'] / max(l2, 1):.3f} ms per launched step ({l2} "
        f"launched), {r['peak'] / 2**20:.0f} MiB; runs' optimize ms "
        f"{[round(x['opt_ms'], 1) for x in banded]}")
    log(f"[mesh:{tag}] launches {json.dumps(r['counts'])}")
    res = r["res"]
    for t in (res.best_pose.quat, res.best_pose.trans, res.best_loss):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"{tag}: non-finite value in the band run")
    same = all(
        torch.equal(res.best_pose.quat, x["res"].best_pose.quat)
        and torch.equal(res.best_pose.trans, x["res"].best_pose.trans)
        and torch.equal(res.best_loss, x["res"].best_loss)
        and res.steps_run == x["res"].steps_run
        and res.rebuilds == x["res"].rebuilds
        and x["counts"] == r["counts"] for x in banded[1:])
    log(f"[mesh:{tag}] band runs bit-equal to each other: {same}")
    if not same:
        raise RuntimeError(f"{tag}: the band runs differ")
    if l2 < res.steps_run or r["counts"][step_kernel] % d:
        raise RuntimeError(f"{tag}: step launches {r['counts'][step_kernel]}"
                           f" for {res.steps_run} steps over {d} bands")
    if not (e2[0] <= MESH_CLASS * max(e1[0], MESH_ET_FLOOR)
            and e2[1] <= MESH_CLASS * max(e1[1], MESH_ER_FLOOR)):
        raise RuntimeError(f"{tag}: band run's eT/eR {e2} out of the "
                           f"single-device run's class {e1}")
    return r["counts"], max(x["peak"] for x in [single] + banded)


def mesh_child(rank, port):
    """Phase 14d, one of two processes: a gloo group of 2 on 127.0.0.1,
    this rank's 2 bands on this card, the full-tile path for
    MESH_TIME_STEPS steps; prints its result (floats as hex) and its
    share of MESH_ROOMS."""
    import torch.distributed as dist

    from gsplatloc_tpu_torch.parallel import (
        global_tile_mesh, initialize, shard_scenes,
    )

    dev = torch.device("cuda", 0)
    if not initialize(f"127.0.0.1:{port}", num_processes=2,
                      process_id=rank):
        raise RuntimeError("initialize() set up no process group")
    try:
        mesh = global_tile_mesh(["cuda:0"] * (MESH_BANDS // 2))
        if (mesh.shape["tiles"], mesh.band0) != (MESH_BANDS,
                                                 rank * MESH_BANDS // 2):
            raise RuntimeError(f"global mesh {mesh}")
        r = run_main_path(make_pair(), dev, MESH_DIST_CONFIG, mesh=mesh)
        out = mesh_result(r)
        out.update(rank=rank, rooms=shard_scenes(MESH_ROOMS),
                   opt_ms=r["opt_ms"], launches=r["counts"]["fused_bwd"])
        print("RESULT " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


MESH_DIST_CONFIG = TrackingConfig(max_steps=MESH_TIME_STEPS, warmup_steps=5,
                                  subtile=False, kcover=0)


def mesh_result(r):
    res = r["res"]
    hexes = [float(v).hex() for t in (res.best_pose.quat,
                                      res.best_pose.trans,
                                      res.final_pose.quat,
                                      res.final_pose.trans) for v in t]
    return dict(steps_run=res.steps_run, pose=hexes,
                best_loss=float(res.best_loss).hex())


def mesh_distributed(pair, dev, mesh):
    """Phase 14d: two processes (`--mesh-rank`), each owning 2 of the 4
    bands on this card through gloo, track the pair on the full-tile path
    for MESH_TIME_STEPS steps; both ranks' poses and losses must be
    bit-equal to each other and to this process's run over the same 4
    bands; shard_scenes must give the ranks MESH_ROOMS[r::2]. Also times
    the full-tile path on one device and in bands for the same steps.
    Returns the largest peak device memory of this process's two runs."""
    single = run_main_path(pair, dev, MESH_DIST_CONFIG)
    local = run_main_path(pair, dev, MESH_DIST_CONFIG, mesh=mesh)
    d = mesh.shape["tiles"]
    for tag, r, n in (("one device", single, 1), (f"{d} bands", local, d)):
        launched = r["counts"]["fused_bwd"] // n
        log(f"[mesh:fulltile] {tag}: {r['opt_ms']:.1f} ms = "
            f"{r['opt_ms'] / max(launched, 1):.3f} ms per launched step "
            f"({launched} launched), {r['peak'] / 2**20:.0f} MiB")
    want = mesh_result(local)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
         str(rank), "--mesh-port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    t0 = time.perf_counter()
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results = []
    for rank, (proc, text) in enumerate(zip(procs, outs)):
        lines = [x for x in text.splitlines() if x.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"rank {rank} failed (exit "
                               f"{proc.returncode}):\n{text[-4000:]}")
        results.append(json.loads(lines[-1][len("RESULT "):]))
    for r in results:
        log(f"[mesh:dist] rank {r['rank']}: steps_run {r['steps_run']} "
            f"best_loss {float.fromhex(r['best_loss']):.6e} rooms "
            f"{r['rooms']}; {r['opt_ms']:.1f} ms for {r['launches']} band "
            f"launches of K7b")
    same = all({k: r[k] for k in want} == want for r in results)
    log(f"[mesh:dist] 2 processes x 2 bands (gloo) bit-equal to each other "
        f"and to one process's {d} bands: {same} "
        f"({time.perf_counter() - t0:.1f} s for both processes)")
    if not same:
        raise RuntimeError(f"distributed results differ: {results} vs {want}")
    if [r["rooms"] for r in results] != [MESH_ROOMS[0::2], MESH_ROOMS[1::2]]:
        raise RuntimeError(f"shard_scenes: {[r['rooms'] for r in results]}")
    return max(single["peak"], local["peak"])


def host_shard_cli():
    """Phase 14e: `cli track --host-shard` in one process equals the run
    without the flag (res.json)."""
    from gsplatloc_tpu_torch import cli

    root = Path(tempfile.mkdtemp(prefix="gsl_shard_"))
    try:
        res = {}
        for flag in ([], ["--host-shard"]):
            run_dir = root / ("shard" if flag else "plain")
            cli.main(["track", "--dataset", "Synthetic", "--frames", "2",
                      "--height", str(H), "--width", str(W), "--num-iters",
                      str(MESH_SHORT_STEPS), "--run-dir", str(run_dir),
                      "--quiet", *flag])
            res[bool(flag)] = json.loads((run_dir / "res.json").read_text())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    same = res[True] == res[False]
    log(f"[mesh:cli] track --host-shard (one process) res.json equal to the "
        f"run without it: {same}; {json.dumps(res[True])}")
    if not same:
        raise RuntimeError("--host-shard changed the result of one process")


def run_mesh(pair, dev):
    """Phase 14: MESH_BANDS tile-row bands on this card. Returns K1 and K2's
    kernels-line entries at a band's row0_px, their launches from (c)'s
    default-path band run."""
    n_cards = torch.cuda.device_count()
    log(f"[mesh] torch.cuda.device_count() = {n_cards}")
    mesh = band_mesh(dev)
    log(f"[mesh] {mesh}")
    torch.cuda.reset_peak_memory_stats()
    entries = check_band_step(pair, dev, mesh)
    torch.cuda.empty_cache()
    check_band_paths(pair, dev, mesh, f"{MESH_BANDS} bands, one card")
    if n_cards > 1:
        from gsplatloc_tpu_torch.parallel import make_tile_mesh

        check_band_paths(pair, dev, make_tile_mesh(),
                         f"{n_cards} cards")
    # (a) and (b) ran under one counter; each tracked run resets it
    peaks = [torch.cuda.max_memory_allocated()]
    torch.cuda.empty_cache()
    counts, peak = mesh_pair(pair, dev, mesh, TrackingConfig(max_steps=300),
                             "kcover16")
    peaks.append(peak)
    for name in DEFAULT_PATH:
        if counts[name] < 1:
            raise RuntimeError(f"the band run never launched {name}")
    if counts["kcover_step_fwd"] != counts["kcover_step_bwd"]:
        raise RuntimeError("forward and backward step launches differ")
    for e in entries:
        e["launches"] = counts[e["name"]]
    short = dict(max_steps=MESH_SHORT_STEPS, warmup_steps=20)
    for cfg, tag, backend, runs in (
            (TrackingConfig(kcover=K_INDEX, **short), "kcover12", "fused", 2),
            (TrackingConfig(kcover=0, **short), "subtile", "fused", 2),
            (TrackingConfig(max_steps=MESH_TIME_STEPS, warmup_steps=5),
             "general", "pallas", 1)):
        peaks.append(mesh_pair(pair, dev, mesh, cfg, tag, backend, runs)[1])
    torch.cuda.empty_cache()
    peaks.append(mesh_distributed(pair, dev, mesh))
    host_shard_cli()
    log(f"[mesh] peak device memory over phase 14 (the largest of its "
        f"stages' peaks): {max(peaks) / 2**20:.0f} MiB")
    return entries


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="smoke run of the port on one "
                                 "GPU (all phases unless --phase is given)")
    ap.add_argument("--phase", type=int, action="append", choices=range(3, 15),
                    help="run only this phase (repeatable; phases 1 and 2 "
                         "always run, the kernels line needs them all)")
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)  # phase 14d's two processes
    ap.add_argument("--mesh-port", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = set(args.phase or range(3, 15))
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    if args.mesh_rank is not None:
        mesh_child(args.mesh_rank, args.mesh_port)
        return
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
    entries, counts = [], {}
    if 3 in phases:
        entries = check_fused_tracking(pair, dev)
        torch.cuda.empty_cache()
        entries += check_kernels(pair, dev)
        torch.cuda.empty_cache()
        entries += check_rasterize(pair, dev)
        torch.cuda.empty_cache()

    # 4. main path (K-cover, the product default), twice
    if 4 in phases:
        counts4, _ = tracked_pair(pair, dev, TrackingConfig(max_steps=300),
                                  "main")
        for name in DEFAULT_PATH:
            if counts4[name] < 1:
                raise RuntimeError(f"main path never launched {name}")
        if counts4["kcover_step_fwd"] != counts4["kcover_step_bwd"]:
            raise RuntimeError("forward and backward step launches differ")
        if counts4["kcover_select"]:
            raise RuntimeError("the K=16 path launched the index select")
        counts.update(counts4)
        torch.cuda.empty_cache()

    # 5. the sub-tile path (kcover=0), twice
    if 5 in phases:
        counts5, _ = tracked_pair(
            pair, dev, TrackingConfig(max_steps=300, kcover=0), "subtile")
        for name in ("project8", "subtile_fwd", "subtile_bwd",
                     "subtile_chain"):
            if counts5[name] < 1:
                raise RuntimeError(f"sub-tile path never launched {name}")
        # every step renders forward and backward; the forward walk runs
        # once more for the pair's depth target
        if not (counts5["subtile_bwd"] == counts5["subtile_chain"]
                == counts5["subtile_fwd"] - 1 == counts5["project8"] - 1):
            raise RuntimeError("forward and backward step launches differ: "
                               f"{counts5}")
        counts.update(subtile_bwd=counts5["subtile_bwd"],
                      subtile_chain=counts5["subtile_chain"])
        torch.cuda.empty_cache()

    # 6. the track entry point
    if 6 in phases:
        run_track_cli(TRACK_RUNS)
        torch.cuda.empty_cache()

    # 7. the general rasterizer
    if 7 in phases:
        from gsplatloc_tpu_torch.ops.parity import general_parity

        t0 = time.perf_counter()
        par = general_parity(device=dev)
        log(f"[general] general_parity 64x128 n=300: ok={par['ok']} fwd_err "
            f"{par['fwd_err']:.3e} a_err {par['a_err']:.3e} grad_rels "
            f"{json.dumps({k: float(f'{v:.3e}') for k, v in par['grad_rels'].items()})}"
            f" ({time.perf_counter() - t0:.1f} s)")
        if not par["ok"]:
            raise RuntimeError(f"general_parity failed on the card: {par}")
        counts7, _ = tracked_pair(pair, dev, TrackingConfig(max_steps=300),
                                  "general", backend="pallas")
        # every step renders forward and backward; the forward runs once
        # more for the pair's depth target
        if not (counts7["rasterize_bwd"] >= 1 and counts7["rasterize_fwd"]
                == counts7["rasterize_bwd"] + 1):
            raise RuntimeError(f"general path launch counts: {counts7}")
        others = {k: v for k, v in counts7.items()
                  if k not in ("rasterize_fwd", "rasterize_bwd") and v}
        if others:
            raise RuntimeError(f"the general path launched other kernels: "
                               f"{others}")
        counts.update(rasterize_fwd=counts7["rasterize_fwd"],
                      rasterize_bwd=counts7["rasterize_bwd"])
        torch.cuda.empty_cache()
        run_track_cli(TRACK_RUNS_GENERAL)
        torch.cuda.empty_cache()

    # 8. the full-tile path, without and with compaction
    if 8 in phases:
        counts8 = {}
        for compact in (False, True):
            counts8[compact] = fulltile_pair(pair, dev, compact)
            torch.cuda.empty_cache()
        run_sequence_fulltile()
        counts.update(fused_fwd=counts8[False]["fused_fwd"],
                      fused_bwd=counts8[False]["fused_bwd"],
                      fused_probe=counts8[True]["fused_probe"])
        torch.cuda.empty_cache()

    # phase 10a's two dense0 frames render in worker processes from here
    # on, while phase 9 runs
    if 10 in phases:
        from concurrent.futures import ThreadPoolExecutor

        from gsplatloc_tpu_torch.data.parser import Parser

        fixture = Parser("ReplicaFixture", "dense0", backend="subtile",
                         knn_method="exact", device=dev, frames=2,
                         height=H, width=W)
        warm = ThreadPoolExecutor(1)
        warmed = warm.submit(fixture.frame, 0)  # asks for frame 1 too

    # 9. the K-cover path at K=12 (the index route)
    if 9 in phases:
        counts9 = kcover12_pair(pair, dev)
        torch.cuda.empty_cache()
        route_times(pair, dev)
        torch.cuda.empty_cache()
        parity_gates(dev)
        torch.cuda.empty_cache()
        c9 = run_track_cli(TRACK_RUNS_K12)["kcover12"]
        if not (c9["kcover_select_records"] == 0
                and c9["kcover_select"] == c9["selects"] + c9["pairs"]):
            raise RuntimeError(f"track --kcover 12 launch counts: {c9}")
        counts.update(kcover_select=counts9["kcover_select"])
        torch.cuda.empty_cache()

    # 10. the Replica fixture suite's first pairs
    if 10 in phases:
        t0 = time.perf_counter()
        warmed.result()
        warm.shutdown()
        log(f"[fixture] dense0 frame 0 waited for {time.perf_counter() - t0:.1f}"
            f" s after phase 9")
        dense = check_path_kernels(fixture, dev, "fixture dense0")
        fixture.dataset.close()
        del fixture
        torch.cuda.empty_cache()
        run_fixture_track()
        torch.cuda.empty_cache()
        for e in entries:
            if e["name"] in dense:
                d = dense[e["name"]]
                e["dense0"] = {k: d[k] for k in ("ms", "plain_ms", "bound_ms",
                                                 "bound_by", "max_abs_err")}

    # 11. the TUM fixture scenes, written and read without OpenCV
    tum_entries = []
    if 11 in phases:
        t0 = time.perf_counter()
        tum_root = Path(tempfile.mkdtemp(prefix="gsl_tum_"))
        try:
            write_tum_scenes(tum_root)
            from gsplatloc_tpu_torch.data.parser import Parser

            desk = Parser("TUM", "freiburg1_desk", backend="subtile",
                          knn_method="exact", device=dev, root=tum_root)
            tum_entries = list(check_path_kernels(desk, dev,
                                                  "tum desk").values())
            del desk
            torch.cuda.empty_cache()
            counts11 = run_tum_track(tum_root)
        finally:
            shutil.rmtree(tum_root, ignore_errors=True)
        for e in tum_entries:
            e["launches"] = counts11[e["name"]]
        torch.cuda.empty_cache()
        log(f"[tum] phase 11: {time.perf_counter() - t0:.1f} s")

    # 12. the classical baselines
    if 12 in phases:
        t0 = time.perf_counter()
        run_icp_cli()
        torch.cuda.empty_cache()
        log(f"[icp] phase 12: {time.perf_counter() - t0:.1f} s")

    # 13. `cli render`: novel views through K6a
    render_entries = []
    if 13 in phases:
        t0 = time.perf_counter()
        render_entries = [run_render(dev)]
        torch.cuda.empty_cache()
        log(f"[render] phase 13: {time.perf_counter() - t0:.1f} s")

    # 14. tile-row bands (parallel/) on this card
    mesh_entries = []
    if 14 in phases:
        t0 = time.perf_counter()
        mesh_entries = run_mesh(pair, dev)
        torch.cuda.empty_cache()
        log(f"[mesh] phase 14: {time.perf_counter() - t0:.1f} s")

    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    if phases != set(range(3, 15)):
        log(f"phases {sorted(phases)} passed (no kernels line: not every "
            "phase ran)")
        return
    for e in entries:
        # launches on the path that runs the kernel: K-cover (phase 4) for
        # K1-K4, K-cover at K=12 (phase 9a) for K8, sub-tile (phase 5) for
        # the sub-tile backward, general (phase 7b) for K6a/K6b, full-tile
        # (phase 8) for K7a/K7b and, with compaction, K7c
        e["launches"] = counts[e["name"]]
    if len(entries) != 13:
        raise RuntimeError(f"{len(entries)} kernels checked, not 13")
    # the default path's kernels again at the TUM shape, their launches
    # from phase 11c's runs
    entries += tum_entries
    # K6a on phase 13's novel view, its launches from 13a's run
    entries += render_entries
    # K1 / K2 at a band's row0_px, their launches from 14c's band run
    entries += mesh_entries
    log(smi_line())
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
