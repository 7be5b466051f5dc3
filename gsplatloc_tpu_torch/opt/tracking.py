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

Three render paths of the fused backend:

  * subtile=True, kcover > 0 (the product default): the K-cover render
    over per-pixel cover records, re-selected by a select gate checked
    every step;
  * subtile=True, kcover = 0: the sub-tile render walking the depth-sorted
    slot buffer itself (ops/fused_subtile.py); only the rebuild gate
    exists;
  * subtile=False (kcover does not apply): the full-tile render walking
    (16, 128) tiles of the slot buffer with in-kernel projection
    (ops/fused_tracking.py); with compact=True each rebuild probes the
    fresh buffer at the rebuild pose and drops the slots that reach no
    live pixel there. Only the rebuild gate exists.

and the general rasterizer (backend "pallas": the tiled hand-written
kernels of ops/rasterize_tiles.py; "reference": the dense oracle), which
projects, bins and renders the whole scene in RGB+ED mode every step and
has no slot buffer and no gate.

The reference runs this as one on-device while_loop; here it is a Python
loop whose pose, Adam state, best-loss bookkeeping and the gate decisions
live in device tensors. The host reads back ONCE per segment of
`resort_every` steps, never once per step, and nothing inside a segment
waits for the card: steps enqueued after a segment's select gate has
tripped are computed and masked out, so the results equal a per-step
check while the step kernels are launched for every enqueued step.

The K-cover path on one device runs each launched step as stages over
fixed tensors (`_KcoverSteps`): K1, the loss and its gradient to the
image (B), K2, then the pose VJP, Adam and the bookkeeping (C). On a
CUDA device B and C are captured once as CUDA graphs and replayed, with
K1 and K2 launched between the replays; on the CPU the same stages run
eagerly. Every other path (kcover = 0, full-tile, general, bands over a
mesh) runs `_pose_step`'s autograd step. Both give the same numbers.

Spans (utils/profiling.py: profiler ranges while one records, host seconds
always): `gsl.segment` around each segment, `gsl.rebuild` / `gsl.select`
around each build of the slot / cover buffer, per launched step
`gsl.step` with `gsl.render`, `gsl.loss`, `gsl.backward`, `gsl.adam`
inside it, and `gsl.read` around a segment's one host read. In the staged
step `gsl.render` is K1's launch, `gsl.loss` stage B, `gsl.backward` K2's
launch and `gsl.adam` stage C (with the next step's camera). Their seconds,
the launched steps, the segments and the launched steps served by graph
replays come back in the PairResult.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import DEFAULT_DEVICE, F32, as_f32, resolve_device
from ..losses import tracking_loss
from ..models.gaussians import GaussianScene
from ..models.pose import PoseState
from ..ops import kcover
from ..ops.fused_subtile import N_SUB, P_SUB, scramble_image, unscramble_image
from ..ops.fused_tracking import cam_vector
from ..ops.lie import invert_se3
from ..utils.profiling import span
from .adam import AdamState, adam_init, adam_step, exponential_lr

# the loop's host-seconds keys (PairResult.host_s), one per span
HOST_KEYS = ("step", "render", "loss", "backward", "adam", "read", "rebuild",
             "select")


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
    # steps enqueued (every segment's range; >= steps_run, the steps after
    # a segment's select gate tripped are masked out)
    launched: int = 0
    # segments, each ended by one host read
    segments: int = 0
    # launched steps whose two plain-torch stages were CUDA graph replays
    replayed: int = 0
    # host seconds of the loop by HOST_KEYS key (the spans' `into`)
    host_s: dict | None = None


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


def _select_into(run, new, old):
    """`_select` written over `old`'s own tensors."""
    if isinstance(new, tuple):
        for n, o in zip(new, old):
            _select_into(run, n, o)
    else:
        torch.where(run, new, old, out=old)


def _copy_into(dst, src):
    """Tree-wise dst.copy_(src)."""
    if isinstance(dst, tuple):
        for d, s_ in zip(dst, src):
            _copy_into(d, s_)
    else:
        dst.copy_(src)


def _clone(tree):
    if isinstance(tree, tuple):
        return type(tree)(*(_clone(t) for t in tree))
    return tree.clone()


def _moved_px(pose, ref_pose, rb_zmin, K, sec2):
    """Conservative screen-motion bound of `pose` since `ref_pose`:
    parallax of the NEAREST visible point (rb_zmin) plus rotation sweep,
    with the image-corner sec^2 factor bounding pan/tilt/roll/forward."""
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


def _gate_factor(counter, config):
    """The coast mode's loosening of both motion gates."""
    if config.coast_after_steps <= 0:
        return 1.0
    return torch.where(counter > config.coast_after_steps,
                       config.coast_gate_factor, 1.0)


def _bookkeep(c: _Carry, loss, dl, sl, pose, adam_q, adam_t,
              config) -> _Carry:
    """The carry after the step at c.pose that gave these losses, the new
    pose and Adam states: best-loss tracking after the warm-up, the
    patience and coast counters, the step count."""
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


def _render_general_depth(scene, viewmat, K, width, height, config,
                          backend, mesh=None):
    """Expected depth (H, W) of the general rasterizer, RGB+ED mode."""
    from ..ops.rasterize import rasterize

    render, _alpha = rasterize(
        scene.means, scene.quats, scene.scales, scene.opacities,
        scene.sh_coeffs, viewmat, K, width, height,
        sh_degree=config.sh_degree, near_plane=config.near_plane,
        far_plane=config.far_plane, render_mode="RGB+ED", backend=backend,
        mesh=mesh,
    )
    return render[..., 3]


def _check_mesh_device(mesh, dev):
    """Raise unless the mesh's first device is `dev`: the image, the loss
    and Adam live there."""
    from ..parallel.sharded import _check_mesh

    _check_mesh(mesh)

    def norm(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    if norm(mesh.device) != norm(dev):
        raise ValueError(f"the mesh's first device {mesh.device} is not the "
                         f"tracking device {dev}")


def _pose_step(render_depth, pose, adam_q, adam_t, step, depth_gt, config,
               gamma, host_s=None):
    """One tracking step: the depth render_depth(viewmat) at `pose`, the
    masked tracking loss, its gradient w.r.t. the pose leaves, and one Adam
    update of each leaf at its decayed learning rate, each in its span
    (host seconds into `host_s`). Returns (loss, depth_loss,
    silhouette_loss, new pose, adam_q, adam_t)."""
    with span("gsl.render", host_s):
        quat = pose.quat.detach().requires_grad_(True)
        trans = pose.trans.detach().requires_grad_(True)
        depth = render_depth(invert_se3(PoseState(quat, trans).to_c2w()))
    with span("gsl.loss", host_s):
        tl = tracking_loss(depth, depth_gt, config.depth_lambda,
                           config.normal_lambda)
    with span("gsl.backward", host_s):
        g_q, g_t = torch.autograd.grad(tl.total, (quat, trans))
    with span("gsl.adam", host_s), torch.no_grad():
        new_q, adam_q = adam_step(
            pose.quat, g_q, adam_q, step,
            exponential_lr(config.quat_lr, gamma, step), config.quat_wd)
        new_t, adam_t = adam_step(
            pose.trans, g_t, adam_t, step,
            exponential_lr(config.trans_lr, gamma, step), config.trans_wd)
    return (tl.total.detach(), tl.depth.detach(), tl.silhouette.detach(),
            PoseState(quat=new_q, trans=new_t), adam_q, adam_t)


# the staged K-cover steps of the last (device, image size, config) on a
# CUDA device, graphs and tensors: a process tracks one configuration at
# a time, and a new one frees the old
_STAGED: dict = {}


class _KcoverSteps:
    """The K-cover path's launched step as stages over fixed ("static")
    tensors, K1 and K2 launched from Python between them:

      K1  `kcover_step_fwd(kbuf, cam)` at a clone of `cam`: the step's
          (2, M_out) rows, copied into `rows`;
      B   (`_loss`) the rows unscrambled, cropped and divided into the
          depth, `tracking_loss` against `depth_gt`, and its gradient
          w.r.t. the two images, scrambled: `g_d`, `g_a` and `loss`
          [total, depth, silhouette];
      K2  `kcover_step_bwd` at the same kbuf and cam with g_d, g_a and
          K1's rows: the 12 pose scalars, copied into `d12`;
      C   (`_update`) this step's gate from the carry before it, the VJP
          of the pose -> cam chain at `_d_cam(d12)`, Adam, the best-loss
          and coast bookkeeping, the carry mask, and (stage A) the next
          step's `cam` from the new carry pose.

    B and C replay `_pose_step`'s ops and its loop's bookkeeping, and
    scramble / unscramble only move data, so the numbers are the parent
    loop's bit for bit. With `graphs` (a CUDA device) B and C are captured
    as CUDA graphs after one eager step and replayed from then on; K1, K2
    and K2's reduction are never captured, so that each launched step
    launches each once, on the step's own cam and the select's own kbuf.
    Without, the same stages run eagerly on the same tensors."""

    def __init__(self, dev, config: TrackingConfig, width: int, height: int,
                 graphs: bool):
        from ..ops.binning import TILE_H, TILE_W

        self.dev, self.config = dev, config
        self.width, self.height = width, height
        self.n_ty, self.n_tx = -(-height // TILE_H), -(-width // TILE_W)
        self.gamma = config.lr_decay_total ** (1.0 / config.max_steps)
        m_out = self.n_ty * self.n_tx * N_SUB * P_SUB

        def f(*shape):
            return torch.zeros(shape, dtype=F32, device=dev)

        def i():
            return torch.zeros((), dtype=torch.int32, device=dev)

        # per call: the camera, the target, the motion bound's factor
        self.K, self.depth_gt, self.sec2 = f(3, 3), f(height, width), f()
        # per segment: the selection pose and nearest depth of the gate,
        # the carried mask and whether a step of the segment has run
        self.sel, self.rb_zmin = PoseState(f(4), f(3)), f()
        self.run = torch.ones((), dtype=torch.bool, device=dev)
        self.mid = torch.zeros((), dtype=torch.bool, device=dev)
        self.c = _Carry(
            step=i(), pose=PoseState(f(4), f(3)),
            adam_q=AdamState(f(4), f(4)), adam_t=AdamState(f(3), f(3)),
            best_loss=f(), best_dl=f(), best_sl=f(),
            best_pose=PoseState(f(4), f(3)), counter=i(), coast_counter=i())
        # per step: what the stages and K1/K2 hand on
        self.cam, self.rows, self.d12 = f(18), f(2, m_out), f(12)
        self.g_d, self.g_a, self.loss = f(m_out), f(m_out), f(3)
        self.graphs = {} if graphs else None
        self.pool = torch.cuda.graph_pool_handle() if graphs else None
        self.warm = False  # a step has run eagerly (before any capture)

    def start(self, c: _Carry, K, depth_gt, sec2) -> None:
        """Load a pair: its initial carry, camera and target; the first
        step's cam."""
        with torch.no_grad():
            _copy_into(self.c, c)
            self.K.copy_(K)
            self.depth_gt.copy_(depth_gt)
            self.sec2.copy_(sec2)
            self._cam()

    def carry(self) -> _Carry:
        """A copy of the carry (the stages overwrite theirs)."""
        return _clone(self.c)

    def segment(self, kbuf, n_seg: int, sel_pose: PoseState, rb_zmin,
                host_s: dict) -> int:
        """Enqueue a segment of n_seg launched steps on the cover `kbuf`,
        with the select gate at `sel_pose` / `rb_zmin`, reading nothing
        back. Returns the steps served by replays."""
        with torch.no_grad():
            _copy_into(self.sel, sel_pose)
            self.rb_zmin.copy_(rb_zmin)
            self.run.fill_(True)
            self.mid.fill_(False)
        replayed = 0
        for _ in range(n_seg):
            with span("gsl.step", host_s):
                replayed += self._step(kbuf, host_s)
        return replayed

    def _step(self, kbuf, host_s) -> bool:
        near, far = self.config.near_plane, self.config.far_plane
        with torch.no_grad():
            with span("gsl.render", host_s):
                cam = self.cam.clone()  # the step's own: C rewrites `cam`
                rows = kcover.kcover_step_fwd(kbuf, cam, self.n_ty,
                                              self.n_tx, near, far)
            with span("gsl.loss", host_s):
                self.rows.copy_(rows)
                rb = self._stage("loss")
            with span("gsl.backward", host_s):
                self.d12.copy_(kcover.kcover_step_bwd(
                    kbuf, cam, self.n_ty, self.n_tx, near, far, self.g_d,
                    self.g_a, rows))
            with span("gsl.adam", host_s):
                rc = self._stage("update")
        if self.graphs is not None:
            self.warm = True
        return rb and rc

    def _stage(self, name: str) -> bool:
        """Run stage `name`: a replay of its graph (captured now if it has
        none yet and a step has warmed the stages up) or eagerly. Returns
        whether it was a replay."""
        fn = getattr(self, "_" + name)
        if self.graphs is None or not self.warm:
            fn()
            return False
        with torch.cuda.device(self.dev):
            g = self.graphs.get(name)
            if g is None:
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, pool=self.pool,
                                      capture_error_mode="thread_local"):
                    fn()
                self.graphs[name] = g
            g.replay()
        return True

    def _cam(self) -> None:
        """Stage A: the carry pose -> the cam vector K1/K2 take."""
        with torch.no_grad():
            vm = invert_se3(self.c.pose.to_c2w())
            self.cam.copy_(cam_vector(vm, self.K, self.width, self.height))

    def _loss(self) -> None:
        """Stage B: the tracking loss of the rows and its gradient to them,
        as `_pose_step` takes them through the K-cover render."""
        n_ty, n_tx, h, w = self.n_ty, self.n_tx, self.height, self.width
        with torch.enable_grad():
            d_img = unscramble_image(self.rows[0], n_ty, n_tx)
            a_img = unscramble_image(self.rows[1], n_ty, n_tx)
            d_img.requires_grad_(True)
            a_img.requires_grad_(True)
            depth = d_img[:h, :w] / a_img[:h, :w].clamp_min(1e-10)
            tl = tracking_loss(depth, self.depth_gt, self.config.depth_lambda,
                               self.config.normal_lambda)
            gd_img, ga_img = torch.autograd.grad(tl.total, (d_img, a_img))
        with torch.no_grad():
            self.g_d.copy_(scramble_image(gd_img, n_ty, n_tx))
            self.g_a.copy_(scramble_image(ga_img, n_ty, n_tx))
            self.loss.copy_(torch.stack([tl.total, tl.depth, tl.silhouette]))

    def _update(self) -> None:
        """Stage C: the step's gate, the pose gradient from K2's 12
        scalars, Adam, the bookkeeping, the masked carry, the next cam."""
        cfg, c = self.config, self.c
        with torch.no_grad():
            # the loop condition before this step; a segment's first step
            # skips the selection staleness gate
            run = self.run
            if cfg.early_stop:
                run = run & (c.counter < cfg.patience)
            run = run & (~self.mid | (
                _moved_px(c.pose, self.sel, self.rb_zmin, self.K, self.sec2)
                <= cfg.select_motion_px * _gate_factor(c.coast_counter, cfg)))
        with torch.enable_grad():
            quat = c.pose.quat.detach().requires_grad_(True)
            trans = c.pose.trans.detach().requires_grad_(True)
            cam = cam_vector(invert_se3(PoseState(quat, trans).to_c2w()),
                             self.K, self.width, self.height)
            # d_cam enters as the weight of a sum: its gradient w.r.t. cam
            # is 1 * d_cam, exactly d_cam. (A tensor passed as grad_outputs
            # makes torch import sympy, seconds at a process's first step.)
            g_q, g_t = torch.autograd.grad(
                (cam * kcover._d_cam(self.d12)).sum(), (quat, trans))
        with torch.no_grad():
            new_q, adam_q = adam_step(
                c.pose.quat, g_q, c.adam_q, c.step,
                exponential_lr(cfg.quat_lr, self.gamma, c.step), cfg.quat_wd)
            new_t, adam_t = adam_step(
                c.pose.trans, g_t, c.adam_t, c.step,
                exponential_lr(cfg.trans_lr, self.gamma, c.step),
                cfg.trans_wd)
            new_c = _bookkeep(c, self.loss[0], self.loss[1], self.loss[2],
                              PoseState(new_q, new_t), adam_q, adam_t, cfg)
            _select_into(run, new_c, c)
            self.run.copy_(run)
            self.mid.fill_(True)
        self._cam()


def _kcover_steps(dev, config: TrackingConfig, width: int,
                  height: int) -> _KcoverSteps:
    """The staged K-cover steps for this device, image and config: on a
    CUDA device the cached ones (graphs captured once), else new eager
    ones."""
    if dev.type != "cuda":
        return _KcoverSteps(dev, config, width, height, graphs=False)
    key = (dev, config, width, height)
    if key not in _STAGED:
        _STAGED.clear()
        _STAGED[key] = _KcoverSteps(dev, config, width, height, graphs=True)
    return _STAGED[key]


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
    mesh=None,
) -> PairResult:
    """Optimize the camera pose of one frame pair on `device`.

    backend "fused": with config.subtile, config.kcover > 0 (the product
    default) is the K-cover tracking path and config.kcover == 0 the
    sub-tile path; subtile=False is the full-tile path whatever kcover
    says, with config.compact its probe + compaction at every rebuild.
    backend "pallas" / "reference": the general rasterizer (the tiled
    hand-written kernels / the dense oracle), rendered in RGB+ED mode with
    config.sh_degree; PairResult.rebuilds == selects == 0.

    mesh: a TileMesh (parallel/sharded.py) whose first device is `device`:
    every render runs in macro-tile-row bands over its devices (the
    K-cover buffer is selected per band) and the full image, the loss and
    Adam stay on `device`. Compaction is off under a mesh, as in the JAX
    package."""
    general = backend in ("pallas", "reference")
    if not general and backend != "fused":
        raise ValueError(f"unknown backend {backend!r}")
    from ..ops.binning import TILE_H, TILE_W
    from ..ops.fused_subtile import (
        build_subtile_slot_buffer,
        render_tracking_depth_subtile,
    )
    from ..ops.fused_tracking import (
        build_slot_buffer,
        compact_slot_buffer,
        fused_probe,
        render_tracking_depth,
    )
    from ..ops.kcover import (
        build_kcover_buffer,
        build_kcover_slot_buffer,
        render_tracking_depth_kcover,
    )

    dev = resolve_device(device)
    if mesh is not None:
        _check_mesh_device(mesh, dev)
    scene = GaussianScene(*(as_f32(a, dev) for a in scene))
    init_c2w = as_f32(init_c2w, dev)
    depth_gt = as_f32(depth_gt, dev)
    K = as_f32(K, dev)
    n_ty = -(-height // TILE_H)
    n_tx = -(-width // TILE_W)
    near, far = config.near_plane, config.far_plane
    use_subtile = config.subtile
    use_kcover = config.kcover > 0 and use_subtile and not general
    do_compact = config.compact and mesh is None and not use_subtile

    def make_slots(viewmat):
        """(slot3d, meta, z_min, overflow) at `viewmat`; overflow is only
        ever True on the K-cover path (live slots beyond the budget)."""
        ovf = torch.zeros((), dtype=torch.bool, device=dev)
        if use_kcover:
            s3, m3, ovf = build_kcover_slot_buffer(
                scene, viewmat, K, width, height, near, far,
                slot_budget=config.slot_budget,
            )
        elif use_subtile:
            s3, m3, _ = build_subtile_slot_buffer(
                scene, viewmat, K, width, height, near, far)
        else:
            s3, m3, _ = build_slot_buffer(
                scene, viewmat, K, width, height, near, far)
            if do_compact:
                contrib, cd = fused_probe(
                    s3, m3, cam_vector(viewmat, K, width, height),
                    n_ty, n_tx, near, far)
                s3, m3 = compact_slot_buffer(s3, m3, contrib, cd)
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
            n_ty, n_tx, near, far, k_cover=config.kcover, mesh=mesh,
        )

    gamma = config.lr_decay_total ** (1.0 / config.max_steps)
    sec2 = (1.0 + (width / (2.0 * K[0, 0])) ** 2
            + (height / (2.0 * K[1, 1])) ** 2)

    def moved_px(pose, ref_pose, rb_zmin):
        return _moved_px(pose, ref_pose, rb_zmin, K, sec2)

    def gate_factor(counter):
        return _gate_factor(counter, config)

    def render_depth(viewmat, buf):
        """buf: the K-cover records, (slot3d, meta) on the sub-tile and
        full-tile paths, or None on the general path."""
        if general:
            return _render_general_depth(scene, viewmat, K, width, height,
                                         config, backend, mesh)
        if use_kcover:
            depth, _alpha = render_tracking_depth_kcover(
                viewmat, K, width, height, buf, near, far, mesh=mesh)
        elif use_subtile:
            depth, _alpha = render_tracking_depth_subtile(
                viewmat, K, width, height, buf[0], buf[1], near, far,
                mesh=mesh)
        else:
            depth, _alpha = render_tracking_depth(
                viewmat, K, width, height, buf[0], buf[1], near, far,
                mesh=mesh)
        return depth

    host_s = dict.fromkeys(HOST_KEYS, 0.0)

    def body_inner(c: _Carry, buf) -> _Carry:
        loss, dl, sl, pose, adam_q, adam_t = _pose_step(
            lambda vm: render_depth(vm, buf), c.pose, c.adam_q, c.adam_t,
            c.step, depth_gt, config, gamma, host_s)
        return _bookkeep(c, loss, dl, sl, pose, adam_q, adam_t, config)

    with torch.no_grad():
        init_pose = PoseState.from_c2w(init_c2w)
        if general:
            slot3d = slot_meta = rb_zmin = None
            overflow = torch.zeros((), dtype=torch.bool, device=dev)
        else:
            with span("gsl.rebuild", host_s):
                slot3d, slot_meta, rb_zmin, overflow = make_slots(
                    invert_se3(init_c2w))
        kbuf = None
        if use_kcover:
            with span("gsl.select", host_s):
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
    # the K-cover path on one device runs the staged step (graphs on a
    # card); the others, bands included, the autograd step
    staged = (_kcover_steps(dev, config, width, height)
              if use_kcover and mesh is None else None)
    if staged is not None:
        staged.start(c, K, depth_gt, sec2)
    rb_pose = sel_pose = init_pose
    n_rebuilds = n_selects = 0
    host_step = host_counter = 0
    do_resort = do_select = False
    seg_len = max(int(config.resort_every), 1)
    n_launched = n_segments = n_replayed = 0

    while host_step < config.max_steps and (
            not config.early_stop or host_counter < config.patience):
        with span("gsl.segment"):
            # segment boundary: at most ONE rebuild and ONE re-selection,
            # both decided on the device at the end of the previous segment
            with torch.no_grad():
                if do_select:
                    # free the stale cover buffer before its successor (and
                    # a rebuild) takes its memory
                    kbuf = buf = None
                if do_resort:
                    with span("gsl.rebuild", host_s):
                        slot3d, slot_meta, rb_zmin, new_ovf = make_slots(
                            invert_se3(c.pose.to_c2w()))
                    overflow = overflow | new_ovf
                    rb_pose = c.pose
                    n_rebuilds += 1
                if do_select:
                    # a binning rebuild always forces re-selection (the
                    # cover must be consistent with the fresh depth order)
                    with span("gsl.select", host_s):
                        kbuf = make_kbuf(slot3d, slot_meta, c.pose)
                    sel_pose = c.pose
                    n_selects += 1
            buf = (kbuf if use_kcover else None if general
                   else (slot3d, slot_meta))

            # enqueue the whole segment without reading anything back;
            # `run` carries the inner loop condition on the device and
            # masks the steps after it turned false
            n_seg = min(seg_len, config.max_steps - host_step)
            if staged is not None:
                n_replayed += staged.segment(kbuf, n_seg, sel_pose, rb_zmin,
                                             host_s)
                c = staged.carry()
            else:
                run = torch.ones((), dtype=torch.bool, device=dev)
                for i in range(n_seg):
                    with span("gsl.step", host_s):
                        with torch.no_grad():
                            if config.early_stop:
                                run = run & (c.counter < config.patience)
                            if use_kcover and i > 0:
                                # selection staleness gate INSIDE the loop
                                # condition; a segment's first step always
                                # runs
                                run = run & (
                                    moved_px(c.pose, sel_pose, rb_zmin)
                                    <= config.select_motion_px
                                    * gate_factor(c.coast_counter))
                        new_c = body_inner(c, buf)
                        with torch.no_grad():
                            c = _select(run, new_c, c)
            n_launched += n_seg
            n_segments += 1

            if general:
                # no slot buffer, no gate: the host reads the two counters
                with torch.no_grad(), span("gsl.read", host_s):
                    host_step, host_counter = torch.stack(
                        [c.step, c.counter]).tolist()
                continue
            with torch.no_grad():
                resort_t = c.step > 0
                if config.resort_motion_px > 0:
                    resort_t = resort_t & (
                        moved_px(c.pose, rb_pose, rb_zmin)
                        > config.resort_motion_px
                        * gate_factor(c.coast_counter))
                if not use_kcover:
                    select_t = torch.zeros((), dtype=torch.bool, device=dev)
                elif config.select_motion_px > 0:
                    select_t = resort_t | (
                        moved_px(c.pose, sel_pose, rb_zmin)
                        > config.select_motion_px
                        * gate_factor(c.coast_counter))
                else:
                    select_t = resort_t | (c.step > 0)
                # THE host read of this segment (one device->host copy):
                # the step and patience counters for the outer loop
                # condition and the two gate decisions for the next boundary
                with span("gsl.read", host_s):
                    host_step, host_counter, do_resort, do_select = (
                        torch.stack([c.step, c.counter,
                                     resort_t.to(torch.int32),
                                     select_t.to(torch.int32)]).tolist())

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
        launched=n_launched,
        segments=n_segments,
        replayed=n_replayed,
        host_s=host_s,
    )


def optimize_pose_recorded(
    scene: GaussianScene,
    init_c2w,
    depth_gt,
    K,
    width: int,
    height: int,
    n_steps: int = 200,
    config: TrackingConfig = TrackingConfig(),
    backend: str = "pallas",
    device=DEFAULT_DEVICE,
    mesh=None,
) -> dict:
    """Debug variant of optimize_pose on the general rasterizer: a FIXED
    number of steps (no early stop, no best-pose bookkeeping), returning
    the per-step (n_steps,) series loss / depth_loss / silhouette_loss, the
    pose before each step (quat (n_steps, 4), trans (n_steps, 3)) and
    final_pose — the single-pair diagnostic harness. mesh: as in
    optimize_pose (the "pallas" backend renders in bands)."""
    if backend not in ("pallas", "reference"):
        raise ValueError(f"optimize_pose_recorded: backend {backend!r} is "
                         "not a general-rasterizer backend")
    dev = resolve_device(device)
    if mesh is not None:
        _check_mesh_device(mesh, dev)
    scene = GaussianScene(*(as_f32(a, dev) for a in scene))
    init_c2w = as_f32(init_c2w, dev)
    depth_gt = as_f32(depth_gt, dev)
    K = as_f32(K, dev)
    gamma = config.lr_decay_total ** (1.0 / config.max_steps)
    with torch.no_grad():
        pose = PoseState.from_c2w(init_c2w)
    adam_q, adam_t = adam_init(pose.quat), adam_init(pose.trans)
    names = ("loss", "depth_loss", "silhouette_loss", "quat", "trans")

    def render_depth(viewmat):
        return _render_general_depth(scene, viewmat, K, width, height,
                                     config, backend, mesh)

    series = {k: [] for k in names}
    for i in range(n_steps):
        step = torch.tensor(i, dtype=torch.int32, device=dev)
        loss, dl, sl, new_pose, adam_q, adam_t = _pose_step(
            render_depth, pose, adam_q, adam_t, step, depth_gt, config, gamma)
        for k, v in zip(names, (loss, dl, sl, pose.quat, pose.trans)):
            series[k].append(v)
        pose = new_pose
    out = {k: torch.stack(v) for k, v in series.items()}
    out["final_pose"] = pose
    return out
