"""Eager pose optimization with early stopping, the parts every tracking
path shares: the benchmark's frozen copy of the port's `opt/tracking.py`
configuration, pair result, loop carry and autograd step, in plain
PyTorch. Each path's loop is in `plainref/paths/<path>.py`.

Per frame pair: forward render -> masked depth+silhouette loss -> backward
-> per-parameter Adam -> exponential lr decay -> best-loss/patience early
stop. Semantics:

  * loss = 0.8*L1(depth*mask) + 0.2*L1(sobel(depth*mask)) with
    mask = (rendered_depth != 0), no gradient through the mask,
  * Adam quat lr 5e-4 / trans lr 1e-3, weight decay 1e-3,
  * lr decay gamma = 0.2^(1/max_steps) per step,
  * best tracking starts after step 100; patience 200 on best TOTAL loss;
    the best (lowest-loss) pose is the pair's estimate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..losses import tracking_loss
from ..models.pose import PoseState
from ..ops.lie import invert_se3
from .adam import AdamState, adam_step, exponential_lr


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
    # full-tile path (subtile=False): after each rebuild, probe the slot
    # buffer at the rebuild pose and compact away the slots that reach no
    # live pixel (exact there; the walks then cover fewer chunks)
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


def _pose_step(render_depth, pose, adam_q, adam_t, step, depth_gt, config,
               gamma):
    """One tracking step: the depth render_depth(viewmat) at `pose`, the
    masked tracking loss, its gradient w.r.t. the pose leaves, and one Adam
    update of each leaf at its decayed learning rate. Returns (loss,
    depth_loss, silhouette_loss, new pose, adam_q, adam_t)."""
    quat = pose.quat.detach().requires_grad_(True)
    trans = pose.trans.detach().requires_grad_(True)
    depth = render_depth(invert_se3(PoseState(quat, trans).to_c2w()))
    tl = tracking_loss(depth, depth_gt, config.depth_lambda,
                       config.normal_lambda)
    g_q, g_t = torch.autograd.grad(tl.total, (quat, trans))
    with torch.no_grad():
        new_q, adam_q = adam_step(
            pose.quat, g_q, adam_q, step,
            exponential_lr(config.quat_lr, gamma, step), config.quat_wd)
        new_t, adam_t = adam_step(
            pose.trans, g_t, adam_t, step,
            exponential_lr(config.trans_lr, gamma, step), config.trans_wd)
    return (tl.total.detach(), tl.depth.detach(), tl.silhouette.detach(),
            PoseState(quat=new_q, trans=new_t), adam_q, adam_t)
