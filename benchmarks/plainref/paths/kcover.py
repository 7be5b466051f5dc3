"""The K-cover tracking path in plain PyTorch: `backend` "fused" with
`TrackingConfig.subtile` and `kcover` > 0, the port's default. Frozen
copies of the port's `data/parser.py:render_depth_gt` with the sub-tile
backend (the depth target through K4a/K4b's plain forms) and of
`opt/tracking.py:optimize_pose` on this path (rebuilds through K-cover
binning, selects through K3's plain form, the step render K1/K2's), run
after the shared prepare of `plainref/pair.py`.

The loop re-selects per-pixel cover records by a select gate checked every
step, over a slot buffer rebuilt by a motion gate at segment boundaries.
The host reads back ONCE per segment of `resort_every` steps: steps
enqueued after a segment's select gate has tripped are computed and masked
out, as in the port.
"""

from __future__ import annotations

import torch

from .._device import DEFAULT_DEVICE, F32, as_f32, resolve_device
from ..models.gaussians import GaussianScene, scene_from_point_cloud
from ..models.pose import PoseState
from ..ops.lie import invert_se3
from ..opt.adam import adam_init
from ..opt.tracking import (
    PairResult,
    TrackingConfig,
    _Carry,
    _pose_step,
    _select,
)
from ..pair import prepare, result


def render_depth_gt(points, K, c2w, height, width, knn_sq_dists, device):
    """The pair's depth target: the src cloud as opacity-1 Gaussians with
    kNN scales, rendered to depth from tar's pose through the sub-tile
    walk (K4a/K4b's plain forms)."""
    from ..ops.fused_subtile import (
        build_subtile_slot_buffer,
        render_tracking_depth_subtile,
    )

    with torch.no_grad():
        scene = scene_from_point_cloud(
            points, torch.zeros_like(points), grid_shape=(height, width),
            knn_sq_dists=knn_sq_dists, device=device)
        vm = invert_se3(as_f32(c2w, device))
        slot, meta, _ = build_subtile_slot_buffer(
            scene, vm, as_f32(K, device), width, height, 1e-2, 1e10)
        depth, _alpha = render_tracking_depth_subtile(
            vm, as_f32(K, device), width, height, slot, meta)
    return depth


def track_pair(tar_depth, tar_c2w, src_depth, src_c2w, K,
               config: TrackingConfig, device) -> dict:
    """Track src against tar on the K-cover path. Depths (H, W) in metres
    as float64 arrays, poses (4, 4), K (3, 3). Returns the pair's best
    pose in its normalized frame (float64 (4, 4)) and its steps run and
    selects."""
    scene, tar_n, depth_gt, Kt, w, h = prepare(
        tar_depth, tar_c2w, src_depth, src_c2w, K, render_depth_gt, device)
    out = optimize_pose(scene, tar_n, depth_gt, Kt, w, h, config=config,
                        device=torch.device(device))
    return result(out)


def optimize_pose(
    scene: GaussianScene,
    init_c2w,  # (4, 4) — tar frame pose
    depth_gt,  # (H, W) re-rendered source depth
    K,  # (3, 3)
    width: int,
    height: int,
    config: TrackingConfig = TrackingConfig(),
    device=DEFAULT_DEVICE,
) -> PairResult:
    """Optimize the camera pose of one frame pair on `device` through the
    K-cover path (`config.subtile` and `config.kcover > 0`, the port's
    default), in plain PyTorch."""
    if not (config.subtile and config.kcover > 0):
        raise ValueError("the reference follows the K-cover path only")
    from ..ops.binning import TILE_H, TILE_W
    from ..ops.fused_tracking import cam_vector
    from ..ops.kcover import (
        build_kcover_buffer,
        build_kcover_slot_buffer,
        render_tracking_depth_kcover,
    )

    dev = resolve_device(device)
    scene = GaussianScene(*(as_f32(a, dev) for a in scene))
    init_c2w = as_f32(init_c2w, dev)
    depth_gt = as_f32(depth_gt, dev)
    K = as_f32(K, dev)
    n_ty = -(-height // TILE_H)
    n_tx = -(-width // TILE_W)
    near, far = config.near_plane, config.far_plane

    def make_slots(viewmat):
        """(slot3d, meta, z_min, overflow) at `viewmat`."""
        s3, m3, ovf = build_kcover_slot_buffer(
            scene, viewmat, K, width, height, near, far,
            slot_budget=config.slot_budget,
        )
        # nearest visible scene depth at the rebuild pose, for the motion
        # gate's parallax bound
        z = scene.means @ viewmat[:3, :3].T[:, 2] + viewmat[2, 3]
        z_min = torch.where(z > near, z, float("inf")).min().clamp_min(near)
        return s3, m3, z_min, ovf

    def make_kbuf(slot3d, slot_meta, pose):
        """Per-pixel K-cover records at `pose`."""
        vm = invert_se3(pose.to_c2w())
        return build_kcover_buffer(
            slot3d, slot_meta, cam_vector(vm, K, width, height),
            n_ty, n_tx, near, far, k_cover=config.kcover,
        )

    gamma = config.lr_decay_total ** (1.0 / config.max_steps)
    sec2 = (1.0 + (width / (2.0 * K[0, 0])) ** 2
            + (height / (2.0 * K[1, 1])) ** 2)

    def moved_px(pose, ref_pose, rb_zmin):
        # conservative screen-motion bound of `pose` since `ref_pose`:
        # parallax of the NEAREST visible point plus rotation sweep, with
        # the image-corner sec^2 factor bounding pan/tilt/roll/forward
        dt = torch.linalg.norm(pose.trans - ref_pose.trans)
        # chord-norm angle: arccos(q.q') has a sqrt(eps_f32) noise floor
        # near identity; the chord form is exact at zero motion
        qn = pose.quat / torch.linalg.norm(pose.quat)
        qrn = ref_pose.quat / torch.linalg.norm(ref_pose.quat)
        chord = torch.minimum(
            torch.linalg.norm(qn - qrn), torch.linalg.norm(qn + qrn)
        )
        ang = 2.0 * torch.arcsin((0.5 * chord).clamp(0.0, 1.0))
        return K[0, 0] * sec2 * (dt / rb_zmin + ang)

    def gate_factor(counter):
        if config.coast_after_steps <= 0:
            return 1.0
        return torch.where(counter > config.coast_after_steps,
                           config.coast_gate_factor, 1.0)

    def render_depth(viewmat, kbuf):
        depth, _alpha = render_tracking_depth_kcover(
            viewmat, K, width, height, kbuf, near, far)
        return depth

    def body_inner(c: _Carry, kbuf) -> _Carry:
        loss, dl, sl, pose, adam_q, adam_t = _pose_step(
            lambda vm: render_depth(vm, kbuf), c.pose, c.adam_q, c.adam_t,
            c.step, depth_gt, config, gamma)

        # best-loss bookkeeping (after warmup)
        track = c.step >= config.warmup_steps + 1
        improved = track & (loss < c.best_loss)
        best_loss = torch.where(improved, loss, c.best_loss)
        best_dl = torch.where(improved, dl, c.best_dl)
        best_sl = torch.where(improved, sl, c.best_sl)
        best_pose = _select(improved, c.pose, c.best_pose)
        counter = torch.where(
            track, torch.where(improved, 0, c.counter + 1), c.counter
        ).to(torch.int32)
        # coast counter: resets only on a >= coast_rtol RELATIVE
        # improvement. inf * (1 - rtol) == inf, so the first tracked
        # improvement still resets it.
        improved_c = track & (loss < c.best_loss * (1.0 - config.coast_rtol))
        coast_counter = torch.where(
            track, torch.where(improved_c, 0, c.coast_counter + 1),
            c.coast_counter
        ).to(torch.int32)

        return _Carry(
            step=c.step + 1,
            pose=pose,
            adam_q=adam_q,
            adam_t=adam_t,
            best_loss=best_loss,
            best_dl=best_dl,
            best_sl=best_sl,
            best_pose=best_pose,
            counter=counter,
            coast_counter=coast_counter,
        )

    with torch.no_grad():
        init_pose = PoseState.from_c2w(init_c2w)
        slot3d, slot_meta, rb_zmin, overflow = make_slots(
            invert_se3(init_c2w))
        kbuf = make_kbuf(slot3d, slot_meta, init_pose)
    inf = torch.full((), float("inf"), dtype=F32, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    c = _Carry(
        step=zero_i,
        pose=init_pose,
        adam_q=adam_init(init_pose.quat),
        adam_t=adam_init(init_pose.trans),
        best_loss=inf,
        best_dl=inf,
        best_sl=inf,
        best_pose=init_pose,
        counter=zero_i,
        coast_counter=zero_i,
    )
    rb_pose = sel_pose = init_pose
    n_rebuilds = n_selects = 0
    host_step = host_counter = 0
    do_resort = do_select = False
    seg_len = max(int(config.resort_every), 1)

    while host_step < config.max_steps and (
            not config.early_stop or host_counter < config.patience):
        # segment boundary: at most ONE rebuild and ONE re-selection, both
        # decided on the device at the end of the previous segment
        with torch.no_grad():
            if do_resort:
                slot3d, slot_meta, rb_zmin, new_ovf = make_slots(
                    invert_se3(c.pose.to_c2w()))
                overflow = overflow | new_ovf
                rb_pose = c.pose
                n_rebuilds += 1
            if do_select:
                # a binning rebuild always forces re-selection (the cover
                # must be consistent with the fresh depth order)
                kbuf = make_kbuf(slot3d, slot_meta, c.pose)
                sel_pose = c.pose
                n_selects += 1

        # enqueue the whole segment without reading anything back; `run`
        # carries the inner loop condition on the device and masks the
        # steps after it turned false
        run = torch.ones((), dtype=torch.bool, device=dev)
        for i in range(min(seg_len, config.max_steps - host_step)):
            with torch.no_grad():
                if config.early_stop:
                    run = run & (c.counter < config.patience)
                if i > 0:
                    # selection staleness gate INSIDE the loop condition;
                    # the first step of a segment always runs
                    run = run & (
                        moved_px(c.pose, sel_pose, rb_zmin)
                        <= config.select_motion_px
                        * gate_factor(c.coast_counter))
            new_c = body_inner(c, kbuf)
            with torch.no_grad():
                c = _select(run, new_c, c)

        with torch.no_grad():
            resort_t = c.step > 0
            if config.resort_motion_px > 0:
                resort_t = resort_t & (
                    moved_px(c.pose, rb_pose, rb_zmin)
                    > config.resort_motion_px * gate_factor(c.coast_counter))
            if config.select_motion_px > 0:
                select_t = resort_t | (
                    moved_px(c.pose, sel_pose, rb_zmin)
                    > config.select_motion_px * gate_factor(c.coast_counter))
            else:
                select_t = resort_t | (c.step > 0)
            # THE host read of this segment (one device->host copy): the
            # step and patience counters for the outer loop condition and
            # the two gate decisions for the next boundary
            host_step, host_counter, do_resort, do_select = torch.stack([
                c.step, c.counter, resort_t.to(torch.int32),
                select_t.to(torch.int32)]).tolist()

    return PairResult(
        best_pose=c.best_pose,
        best_loss=c.best_loss,
        best_depth_loss=c.best_dl,
        best_silhouette_loss=c.best_sl,
        final_pose=c.pose,
        steps_run=int(host_step),
        rebuilds=n_rebuilds,
        selects=n_selects,
        slot_overflow=bool(overflow),
    )


