"""Eager on-device pose optimization with early stopping.

Per frame pair: forward render -> masked depth+silhouette loss -> backward
-> per-parameter Adam -> exponential lr decay -> best-loss/patience early
stop. Semantics:

  * loss = 0.8*L1(depth*mask) + 0.2*L1(sobel(depth*mask)) with
    mask = (rendered_depth != 0), no gradient through the mask,
  * Adam quat lr 5e-4 / trans lr 1e-3, weight decay 1e-3,
  * lr decay gamma = 0.2^(1/max_steps) per step,
  * best tracking starts after step 100; patience 200 on best TOTAL loss;
    the best (lowest-loss) pose is the pair's estimate.

Two render paths of the fused backend (both subtile=True):

  * kcover > 0 (the product default): the K-cover render over per-pixel
    cover records, re-selected by a select gate checked every step;
  * kcover = 0: the sub-tile render walking the depth-sorted slot buffer
    itself (ops/fused_subtile.py); only the rebuild gate exists.

The reference runs this as one on-device while_loop; here it is an eager
Python loop whose pose, Adam state, best-loss bookkeeping and the gate
decisions live in device tensors. The host reads back ONCE per segment of
`resort_every` steps, never once per step: steps enqueued after a
segment's select gate has tripped are computed and masked out, so the
results equal a per-step check while the step kernels are launched for
every enqueued step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import DEFAULT_DEVICE, F32, as_f32, resolve_device
from ..losses import tracking_loss
from ..models.gaussians import GaussianScene
from ..models.pose import PoseState
from ..ops.lie import invert_se3
from .adam import AdamState, adam_init, adam_step, exponential_lr


class TrackingConfig(NamedTuple):
    max_steps: int = 1000
    patience: int = 200
    warmup_steps: int = 100  # best-loss tracking starts AFTER this many steps
    early_stop: bool = True
    depth_lambda: float = 0.8
    normal_lambda: float = 0.0
    quat_lr: float = 5e-4
    trans_lr: float = 1e-3
    quat_wd: float = 1e-3
    trans_wd: float = 1e-3
    lr_decay_total: float = 0.2  # gamma = lr_decay_total ** (1/max_steps)
    sh_degree: int = 1
    near_plane: float = 1e-2
    far_plane: float = 1e10
    # fused backend: segment length — the slot list (binning + sort) can be
    # rebuilt only at segment boundaries. Between rebuilds tile assignment
    # and depth ORDER are stale while every projected quantity stays exact.
    resort_every: int = 10
    # fused backend: rebuild only when the accumulated pose motion since the
    # last rebuild exceeds this many pixels (conservative screen-motion
    # bound: fx * (|dt|/z_nearest + dtheta)). 0 = cadence only.
    resort_motion_px: float = 4.0
    # full-tile path option of the reference (not ported yet)
    compact: bool = False
    # fused backend: the (16, 16) sub-tile pipeline (ops/fused_subtile.py)
    subtile: bool = True
    # fused backend, K > 0: per-pixel K-cover rendering (ops/kcover.py) —
    # each re-selection picks every pixel's first-K covering splats and
    # pre-gathers their records; the per-step render composites only
    # K*Npix pairs. A frozen cover set is MORE staleness-sensitive than the
    # binning, so the selection motion gate rides the INNER loop condition:
    # a segment ends the step the motion since the last selection exceeds
    # select_motion_px, and the boundary then re-selects. K=16 is the
    # product default. 0 = off.
    kcover: int = 16
    # COAST MODE: near a pair's loss floor Adam random-walks the pose, so
    # every staleness gate fires constantly while the loss no longer
    # improves. Once the coast counter exceeds coast_after_steps both
    # motion gates loosen by coast_gate_factor; any genuine improvement
    # resets the counter and re-tightens them.
    coast_after_steps: int = 30
    coast_gate_factor: float = 8.0
    # the coast counter resets only on RELATIVE improvement >= coast_rtol
    # (the early-stop patience keeps the strict `loss < best`). 0 = strict.
    coast_rtol: float = 1e-3
    select_motion_px: float = 2.0
    # K-cover rebuild slot budget: fraction of emitted binning slots kept
    # after the depth sort (ops/kcover.py build_kcover_slot_buffer); when
    # the LIVE count exceeds it PairResult.slot_overflow reports it.
    slot_budget: float = 0.7


class PairResult(NamedTuple):
    best_pose: PoseState
    best_loss: torch.Tensor
    best_depth_loss: torch.Tensor
    best_silhouette_loss: torch.Tensor
    final_pose: PoseState
    steps_run: int
    # slot-list rebuilds that actually fired (motion-gated)
    rebuilds: int = 0
    # cover re-selections that actually fired
    selects: int = 0
    # True iff any rebuild's live slot count exceeded the slot_budget prefix
    slot_overflow: bool = False


class _Carry(NamedTuple):
    step: torch.Tensor  # int32 scalar
    pose: PoseState
    adam_q: AdamState
    adam_t: AdamState
    best_loss: torch.Tensor
    best_dl: torch.Tensor
    best_sl: torch.Tensor
    best_pose: PoseState
    counter: torch.Tensor  # int32: steps since the last strict improvement
    # steps since the last >= coast_rtol RELATIVE improvement — drives the
    # coast gate-loosening only (early stop uses `counter`)
    coast_counter: torch.Tensor


def _select(run, new, old):
    """Tree-wise torch.where(run, new, old) over a _Carry."""
    if isinstance(new, tuple):
        return type(new)(*(_select(run, n, o) for n, o in zip(new, old)))
    return torch.where(run, new, old)


def optimize_pose(
    scene: GaussianScene,
    init_c2w,  # (4, 4) — tar frame pose
    depth_gt,  # (H, W) re-rendered source depth
    K,  # (3, 3)
    width: int,
    height: int,
    config: TrackingConfig = TrackingConfig(),
    backend: str = "fused",
    device=DEFAULT_DEVICE,
) -> PairResult:
    """Optimize the camera pose of one frame pair on `device`.

    backend "fused" with config.subtile is ported: config.kcover > 0 (the
    product default) is the K-cover tracking path, config.kcover == 0 the
    sub-tile path. The general rasterizer (other backends) and the
    full-tile path (subtile=False) are later slices of the port and raise
    NotImplementedError."""
    if backend != "fused" or not config.subtile:
        raise NotImplementedError(
            f"optimize_pose(backend={backend!r}, subtile={config.subtile}): "
            "only backend='fused' with subtile=True is ported")
    from ..ops.binning import TILE_H, TILE_W
    from ..ops.fused_subtile import (
        build_subtile_slot_buffer,
        render_tracking_depth_subtile,
    )
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
    use_kcover = config.kcover > 0

    def make_slots(viewmat):
        """(slot3d, meta, z_min, overflow) at `viewmat`; overflow is only
        ever True on the K-cover path (live slots beyond the budget)."""
        if use_kcover:
            s3, m3, ovf = build_kcover_slot_buffer(
                scene, viewmat, K, width, height, near, far,
                slot_budget=config.slot_budget,
            )
        else:
            s3, m3, _ = build_subtile_slot_buffer(
                scene, viewmat, K, width, height, near, far)
            ovf = torch.zeros((), dtype=torch.bool, device=dev)
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

    def loss_and_grads(pose, buf):
        """buf: the K-cover records, or (slot3d, meta) when kcover == 0."""
        quat = pose.quat.detach().requires_grad_(True)
        trans = pose.trans.detach().requires_grad_(True)
        viewmat = invert_se3(PoseState(quat, trans).to_c2w())
        if use_kcover:
            depth, _alpha = render_tracking_depth_kcover(
                viewmat, K, width, height, buf, near, far)
        else:
            depth, _alpha = render_tracking_depth_subtile(
                viewmat, K, width, height, buf[0], buf[1], near, far)
        tl = tracking_loss(depth, depth_gt, config.depth_lambda,
                           config.normal_lambda)
        g_q, g_t = torch.autograd.grad(tl.total, (quat, trans))
        return tl.total.detach(), tl.depth.detach(), tl.silhouette.detach(), g_q, g_t

    def body_inner(c: _Carry, buf) -> _Carry:
        loss, dl, sl, g_q, g_t = loss_and_grads(c.pose, buf)

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

        lr_q = exponential_lr(config.quat_lr, gamma, c.step)
        lr_t = exponential_lr(config.trans_lr, gamma, c.step)
        new_q, adam_q = adam_step(
            c.pose.quat, g_q, c.adam_q, c.step, lr_q, config.quat_wd
        )
        new_t, adam_t = adam_step(
            c.pose.trans, g_t, c.adam_t, c.step, lr_t, config.trans_wd
        )
        return _Carry(
            step=c.step + 1,
            pose=PoseState(quat=new_q, trans=new_t),
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
        slot3d, slot_meta, rb_zmin, overflow = make_slots(invert_se3(init_c2w))
        kbuf = make_kbuf(slot3d, slot_meta, init_pose) if use_kcover else None
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
        buf = kbuf if use_kcover else (slot3d, slot_meta)

        # enqueue the whole segment without reading anything back; `run`
        # carries the inner loop condition on the device and masks the
        # steps after it turned false
        run = torch.ones((), dtype=torch.bool, device=dev)
        for i in range(min(seg_len, config.max_steps - host_step)):
            with torch.no_grad():
                if config.early_stop:
                    run = run & (c.counter < config.patience)
                if use_kcover and i > 0:
                    # selection staleness gate INSIDE the loop condition;
                    # the first step of a segment always runs
                    run = run & (
                        moved_px(c.pose, sel_pose, rb_zmin)
                        <= config.select_motion_px
                        * gate_factor(c.coast_counter))
            new_c = body_inner(c, buf)
            with torch.no_grad():
                c = _select(run, new_c, c)

        with torch.no_grad():
            resort_t = c.step > 0
            if config.resort_motion_px > 0:
                resort_t = resort_t & (
                    moved_px(c.pose, rb_pose, rb_zmin)
                    > config.resort_motion_px * gate_factor(c.coast_counter))
            if not use_kcover:
                select_t = torch.zeros((), dtype=torch.bool, device=dev)
            elif config.select_motion_px > 0:
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
