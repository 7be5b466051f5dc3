"""K-cover tracking renderer: per-pixel top-K splat lists.

With opacity-1 scenes each pixel's transmittance saturates after 2-3
covering splats, and between rebuilds the pose moves less than the
staleness budget the binning already rides, so the SET of splats covering
a pixel is as static as the tile assignment:

  1. SELECT (once per re-selection): walk the depth-sorted sub-tile
     segments of the slot buffer and emit for every pixel the 3D records
     [x, y, z, s2, opa] of its first K alpha hits, front to back, into a
     dense (NREC_KC=5, K, M_out) cover buffer (`select_kcover_records`).
  2. RENDER (every step): project the K records per pixel with the CURRENT
     pose, evaluate alpha at the pixel centre and composite over the K
     axis (`render_kcover`); differentiable w.r.t. the cam vector through
     a hand-written backward that reduces straight to the 12 pose scalars.

Kernels (csrc/), each with its plain PyTorch version in this module:
  kcover_step_fwd        (csrc/kcover_step.cu)   plain: _kcover_step_fwd_plain
      replaces the Pallas _kcover_step_fwd_kernel
  kcover_step_bwd        (csrc/kcover_step.cu)   plain: _kcover_step_bwd_plain
      replaces the Pallas _kcover_step_bwd_kernel
  select_kcover_records  (csrc/kcover_select.cu) plain: _select_records_plain
      replaces the Pallas _kcover_select_records_kernel
A wrapper takes its plain version ONLY for a CPU tensor; for a CUDA tensor
it launches the kernel or raises.

Selection semantics: liveness is exact per pixel (a pixel admits hits only
while its own transmittance is above T_EPS). The reference's TPU kernel
gates liveness per 256-slot block and may admit post-death hits into the
tail of a K-list; the render weighs those at <= T_EPS in total, so the two
buffers render alike to within T_EPS while their dead tails differ.
"""

from __future__ import annotations

import torch

from .. import kernels
from .._device import F32
from .fused_subtile import (
    ALPHA_MAX,
    ALPHA_MIN,
    CB,
    CHUNK,
    KX_SUB,
    KY_SUB,
    N_SUB,
    N_SUB_X,
    P_SUB,
    SIG_EPS,
    SUB_H,
    SUB_W,
    T_EPS,
    _coeff_mat,
    _segment_bounds,
    _segment_origins,
    _sub_alpha,
    _sub_mono,
    iso_records,
    scramble_image,
    unscramble_image,
)
from .fused_tracking import (
    _pose_chain,
    _project8_rows,
    _project_slots,
    cam_vector,
)

# cover-record rows: [x, y, z, s2, opa] — the slot buffer's 3 padding rows
# are NOT replicated into the cover buffer.
NREC_KC = 5


# ---------------------------------------------------------------------------
# K3: records select
# ---------------------------------------------------------------------------

def _select_records_plain(slot3d, meta, cam, n_ty, n_tx, k_cover, near, far,
                          stats=None):
    """Plain PyTorch select with the kernel's EXACT per-pixel semantics:
    every segment advances one slot per iteration (vectorized over
    segments and pixels); a pixel appends a slot's record iff the slot's
    gated alpha is > 0 while the pixel's own transmittance is > T_EPS and
    it holds fewer than K records. Reads the longest segment length (and a
    done flag every 64 slots) back to the host. stats (optional dict)
    receives the work this input needs: `pairs` ((slot, pixel) pairs met
    by a still-selecting pixel) and `slots` (slots met by a sub-tile with
    at least one such pixel)."""
    dev = slot3d.device
    n_seg = n_ty * n_tx * N_SUB
    m_out = n_seg * P_SUB
    b_pad = slot3d.shape[1]
    p8 = _project8_rows(_project_slots(slot3d, cam), near, far)
    starts, ends = _segment_bounds(meta, n_seg)
    seg_len = ends - starts
    max_len = int(seg_len.max())
    x0, y0 = _segment_origins(meta, n_seg, n_tx)
    mono = _sub_mono(dev)
    out = torch.zeros((n_seg, k_cover, NREC_KC, P_SUB), dtype=F32, device=dev)
    t = torch.ones((n_seg, P_SUB), dtype=F32, device=dev)
    cnt = torch.zeros((n_seg, P_SUB), dtype=torch.int64, device=dev)
    n_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    n_slots = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(max_len):
        if j % 64 == 0:
            busy = (t > T_EPS) & (cnt < k_cover) & (j < seg_len)[:, None]
            if not bool(busy.any()):
                break
        inseg = (j < seg_len)[:, None]
        idx = (starts + j).clamp_max(b_pad - 1)
        mat = _coeff_mat(p8[:, idx], x0[None, :], y0[None, :])
        alpha = torch.where(inseg, _sub_alpha(mat, mono), 0.0)
        hit = (alpha > 0.0) & (t > T_EPS) & (cnt < k_cover)
        if stats is not None:
            sel = (t > T_EPS) & (cnt < k_cover) & inseg
            n_pairs += sel.sum()
            n_slots += sel.any(dim=1).sum()
        rec = slot3d[:NREC_KC, idx].T  # (n_seg, 5)
        index = cnt.clamp_max(k_cover - 1)[:, None, None, :].expand(
            n_seg, 1, NREC_KC, P_SUB)
        cur = out.gather(1, index)
        new = torch.where(hit[:, None, None, :],
                          rec[:, None, :, None].expand_as(cur), cur)
        out.scatter_(1, index, new)
        cnt = cnt + hit.to(torch.int64)
        t = torch.where(hit, t * (1.0 - alpha), t)
    if stats is not None:
        stats["pairs"] = int(n_pairs)
        stats["slots"] = int(n_slots)
    # (n_seg, K, 5, P) -> (5, K, M_out)
    return out.permute(2, 1, 0, 3).reshape(NREC_KC, k_cover, m_out).contiguous()


def select_kcover_records(slot3d, meta, cam, n_ty: int, n_tx: int,
                          k_cover: int, near: float, far: float):
    """(NREC_KC, k_cover, M_out) f32: each pixel's first-K cover slot
    RECORDS (scrambled sub-tile-major pixel layout; uncovered = zero
    record), projected in-kernel from slot3d with `cam`.

    CUDA tensor: the hand-written kernel (csrc/kcover_select.cu, which
    replaces the Pallas _kcover_select_records_kernel; bound by operations
    — one block per sub-tile, one thread per pixel, slots projected once
    while staged into shared memory). CPU tensor: `_select_records_plain`."""
    if not slot3d.is_cuda:
        return _select_records_plain(slot3d, meta, cam, n_ty, n_tx, k_cover,
                                     near, far)
    n_seg = n_ty * n_tx * N_SUB
    m_out = n_seg * P_SUB
    b_pad = slot3d.shape[1]
    kernels.require(slot3d, "slot3d", (8, b_pad))
    kernels.require(meta, "meta", (n_seg + 2,), dtype=torch.int32,
                    device=slot3d.device)
    cam = cam.detach().contiguous()
    kernels.require_cam(cam, slot3d.device)
    # uncovered entries are zero records: the kernel writes hits only
    out = torch.zeros((NREC_KC, k_cover, m_out), dtype=F32,
                      device=slot3d.device)
    lib = kernels.load()
    err = lib.gsl_kcover_select_records(
        meta.data_ptr(), cam.data_ptr(), slot3d.data_ptr(), out.data_ptr(),
        k_cover, b_pad, m_out, n_seg, n_tx, float(near), float(far),
        kernels.stream_ptr())
    kernels.check(err, "kcover_select_records")
    select_kcover_records.launches += 1
    return out


select_kcover_records.launches = 0


def build_kcover_buffer(slot3d, meta, cam, n_ty: int, n_tx: int,
                        near: float, far: float, k_cover: int = 8,
                        via: str = "records"):
    """Re-selection: each pixel's K cover records as a dense
    (NREC_KC, K, M_out) buffer (the step loop reads it with zero gathers).
    Only via="records" (the select emits the records directly) is ported;
    the index-emitting cross-check form is a later slice."""
    if via != "records":
        raise NotImplementedError(
            f"build_kcover_buffer(via={via!r}): only via='records' is "
            "ported (the index-emitting select is a later slice)")
    with torch.no_grad():
        return select_kcover_records(slot3d, meta, cam, n_ty, n_tx, k_cover,
                                     near, far)


def build_kcover_slot_buffer(scene, viewmat, K, width: int, height: int,
                             near: float, far: float, big_budget: int = 64,
                             slot_budget: float = 0.7):
    """Rebuild-time slot buffer for the K-COVER path: the depth-sorted
    sub-tile work list WITHOUT chunk padding, truncated to a live-slot
    budget. Returns (slot3d (8, B_pad), meta, overflow_flag).

    The select masks segment membership per slot, so the chunk-aligned
    padded layout buys nothing here; dead emissions (a small splat
    overlaps ~1.45 of its KY*KX = 4 emitted tiles) sort to the tail (tile
    id = n_tiles), so keeping a `slot_budget` fraction of the sorted
    prefix drops them without touching any live segment.

    slot_budget: fraction of emitted slots kept (1.0 = everything). The
    kept prefix is padded to a CB-aligned static length; per-segment
    starts are clamped to it. overflow_flag (device bool) is True iff the
    LIVE count exceeded the kept prefix — then the highest-id sub-tiles
    lost cover slots and the caller must surface it."""
    from .binning import TILE_H, TILE_W, bin_and_sort
    from .projection import project_iso_binning

    n_tx = -(-width // TILE_W)
    n_ty = -(-height // TILE_H)
    with torch.no_grad():
        proj = project_iso_binning(
            scene.means, scene.scales[:, 0] * scene.scales[:, 0],
            viewmat, K, width, height, near, far,
        )
        binning = bin_and_sort(
            proj.mean2d, proj.radius, proj.depth, proj.valid,
            n_tx * TILE_W, n_ty * TILE_H,
            tile_h=SUB_H, tile_w=SUB_W, ky=KY_SUB, kx=KX_SUB, chunk=CHUNK,
            needs_inv_perm=False, big_budget=big_budget,
            pad_to_chunks=False,
        )
        m_emit = binning.num_pairs  # static
        budget = m_emit if slot_budget >= 1.0 else int(m_emit * slot_budget)
        b_pad = -(-max(budget, CB) // CB) * CB  # static
        sg = binning.pair_gauss  # (m_pad,) sorted gauss idx (+ zero padding)
        n = scene.means.shape[0]
        if b_pad <= sg.shape[0]:
            sg_b = sg[:b_pad]
        else:
            sg_b = torch.nn.functional.pad(sg, (0, b_pad - sg.shape[0]),
                                           value=n)
        records = iso_records(scene)  # (N + 1, 8), dummy row N
        slot3d = records[sg_b.long()].T.contiguous()  # (8, b_pad)
        # positions >= min(b_pad, m_emit) hold pad/dead content — clamp
        # every segment bound there so no walk consumes them
        clamp_at = min(b_pad, m_emit)
        starts = binning.tile_starts.clamp_max(clamp_at)
        overflow = binning.tile_starts[-1] > clamp_at
        meta = torch.cat([
            torch.zeros((1,), dtype=torch.int32, device=starts.device),
            starts,
        ])
    return slot3d, meta, overflow


# ---------------------------------------------------------------------------
# K1 / K2: step render
# ---------------------------------------------------------------------------

def _pixel_centers(n_ty: int, n_tx: int, m_out: int, row0_px=0.0,
                   device="cpu"):
    """(M_out,) px/py pixel-centre rows in the scrambled flat layout."""
    f = torch.arange(m_out, device=device)
    st = f // P_SUB
    within = f % P_SUB
    n_gx = n_tx * N_SUB_X
    gy = st // n_gx
    gx = st % n_gx
    r = within // SUB_W
    c = within % SUB_W
    px = (gx * SUB_W + c).to(F32) + 0.5
    py = (gy * SUB_H + r).to(F32) + 0.5 + row0_px
    return px, py


def _kcover_fwd_pieces(kbuf, cam, n_ty: int, n_tx: int,
                       near: float, far: float, row0_px=0.0):
    """Shared forward math: projection + per-(k, pixel) alpha + exclusive
    transmittance. Returns (pr, alpha_raw, alpha, ok, live, t_excl, w, qz,
    px, py)."""
    nrec, k_cover, m_out = kbuf.shape
    rec = kbuf.reshape(nrec, k_cover * m_out)
    pr = _project_slots(rec, cam)
    p8 = _project8_rows(pr, near, far)
    u, v, ca, cb, cc, qz, opa, okr = [
        p8[i].reshape(k_cover, m_out) for i in range(8)
    ]
    px, py = _pixel_centers(n_ty, n_tx, m_out, row0_px, device=kbuf.device)
    dx = px - u
    dy = py - v
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    alpha_raw = opa * torch.exp(-sigma)
    alpha = torch.clamp_max(alpha_raw, ALPHA_MAX)
    # -SIG_EPS, not 0: the select gates with the expanded sigma polynomial
    # at sigma >= -SIG_EPS; the render must share that gate definition or a
    # selected record can be dropped pixel-flip-wise at zero staleness.
    ok = (sigma >= -SIG_EPS) & (alpha >= ALPHA_MIN) & (okr > 0.0)
    alpha = torch.where(ok, alpha, 0.0)

    # front-to-back compositing over the K axis: exclusive transmittance
    t_excl = torch.cat(
        [torch.ones((1, m_out), dtype=F32, device=kbuf.device),
         torch.cumprod(1.0 - alpha[:-1], dim=0)], dim=0,
    )
    # the slot whose INCLUSIVE transmittance crosses T_EPS is excluded
    # entirely; T itself still decays through the excluded slot.
    live = (t_excl * (1.0 - alpha)) > T_EPS
    w = torch.where(live, t_excl * alpha, 0.0)  # (K, M_out)
    return pr, alpha_raw, alpha, ok, live, t_excl, w, qz, px, py


def _kcover_step_fwd_plain(kbuf, cam, n_ty, n_tx, near, far):
    """Plain PyTorch K-cover step forward: (2, M_out) scrambled rows
    [depth_acc; alpha]."""
    _pr, _ar, _al, _ok, _lv, _te, w, qz, _px, _py = _kcover_fwd_pieces(
        kbuf, cam, n_ty, n_tx, near, far)
    return torch.stack([torch.sum(w * qz, dim=0), torch.sum(w, dim=0)])


def render_kcover_ref(kbuf, cam, n_ty: int, n_tx: int,
                      near: float, far: float, row0_px=0.0):
    """Autograd-oracle form of the K-cover render (plain PyTorch backward);
    `render_kcover` is validated against this."""
    _pr, _ar, _al, _ok, _lv, _te, w, qz, _px, _py = _kcover_fwd_pieces(
        kbuf, cam, n_ty, n_tx, near, far, row0_px)
    dacc = torch.sum(w * qz, dim=0)
    aacc = torch.sum(w, dim=0)
    return (unscramble_image(dacc, n_ty, n_tx),
            unscramble_image(aacc, n_ty, n_tx))


def _kcover_step_bwd_plain(kbuf, cam, n_ty, n_tx, near, far, g_d, g_a):
    """Plain PyTorch hand-written backward to the pose: recompute the
    forward, run the alpha-compositing backward over the K axis, and chain
    d_sigma / the direct depth term to the pose with ONE `_pose_chain`
    call. Each record instance touches exactly one pixel, so its moment
    frame is that pixel itself (x0=px, y0=py): the only nonzero moment is
    m0 = d_sigma. g_d/g_a: (M_out,) scrambled cotangents. Returns the 12
    pose scalars [dR(9), dt(3)]."""
    _, k_cover, m_out = kbuf.shape
    g_d = g_d[None, :]
    g_a = g_a[None, :]
    pr, alpha_raw, alpha, ok, live, t_excl, w, qz, px, py = (
        _kcover_fwd_pieces(kbuf, cam, n_ty, n_tx, near, far))

    # d_alpha_k = live_k * t_excl_k * phi_k
    #            - (sum_{j>k} phi_j w_j) / (1 - alpha_k)
    phi = g_d * qz + g_a
    wdw = w * phi
    s_incl = torch.cumsum(wdw, dim=0)
    suffix = s_incl[-1:, :] - s_incl
    inv_om = 1.0 / torch.clamp_min(1.0 - alpha, 1.0 - ALPHA_MAX)
    d_alpha = torch.where(live, t_excl * phi, 0.0) - suffix * inv_om
    d_alpha = torch.where(ok & (alpha_raw < ALPHA_MAX), d_alpha, 0.0)
    d_sigma = d_alpha * (-alpha)
    qz_bar = w * g_d

    km = k_cover * m_out
    zero = torch.zeros((1, km), dtype=F32, device=kbuf.device)
    d = _pose_chain(
        pr,
        d_sigma.reshape(1, km), zero, zero, zero, zero, zero,
        qz_bar.reshape(1, km),
        px[None, :].expand(k_cover, m_out).reshape(1, km),
        py[None, :].expand(k_cover, m_out).reshape(1, km),
        cam[0], cam[1],
    )
    return d[0, :12]


def _kcover_cv_bwd(n_ty, n_tx, near, far, res, cot):
    """Hand-written backward of `render_kcover_ref` to the cam vector.
    res = (kbuf, cam), cot = (gd_img, ga_img). Returns d_cam (18,) with
    slots 4..15 (R, t) filled; the raw dR rows carry a manifold-normal
    component that the quat -> R backward projects out."""
    kbuf, cam = res
    gd_img, ga_img = cot
    g_d = scramble_image(gd_img, n_ty, n_tx)
    g_a = scramble_image(ga_img, n_ty, n_tx)
    d = _kcover_step_bwd_plain(kbuf, cam, n_ty, n_tx, near, far, g_d, g_a)
    return _d_cam(d)


def _d_cam(d12):
    z = d12.new_zeros
    return torch.cat([z((4,)), d12[:12], z((2,))])


def _check_step_args(kbuf, cam):
    nrec, k_cover, m_out = kbuf.shape
    kernels.require(kbuf, "kbuf", (NREC_KC, k_cover, m_out))
    kernels.require_cam(cam, kbuf.device)
    if m_out % P_SUB:
        raise ValueError(f"m_out={m_out} is not a multiple of {P_SUB}")
    return k_cover, m_out


def kcover_step_fwd(kbuf, cam, n_ty, n_tx, near, far):
    """K-cover step forward: (2, M_out) scrambled rows [depth_acc; alpha].
    CUDA tensor: the hand-written kernel (csrc/kcover_step.cu
    kcover_step_fwd_kernel, which replaces the Pallas
    _kcover_step_fwd_kernel; bound by bytes — one thread per pixel streams
    its K records, coalesced, and stops at a dead transmittance). CPU
    tensor: `_kcover_step_fwd_plain`."""
    if not kbuf.is_cuda:
        return _kcover_step_fwd_plain(kbuf, cam, n_ty, n_tx, near, far)
    k_cover, m_out = _check_step_args(kbuf, cam)
    out = torch.empty((2, m_out), dtype=F32, device=kbuf.device)
    lib = kernels.load()
    err = lib.gsl_kcover_step_fwd(
        cam.data_ptr(), kbuf.data_ptr(), out.data_ptr(), k_cover, m_out,
        n_tx, float(near), float(far), kernels.stream_ptr())
    kernels.check(err, "kcover_step_fwd")
    kcover_step_fwd.launches += 1
    return out


kcover_step_fwd.launches = 0

def kcover_step_bwd(kbuf, cam, n_ty, n_tx, near, far, g_d, g_a):
    """K-cover step backward: the 12 pose scalars [dR(9), dt(3)] from the
    scrambled cotangent rows g_d/g_a (M_out,). CUDA tensor: the
    hand-written kernel pair (csrc/kcover_step.cu kcover_step_bwd_kernel +
    the fixed-order block reduction, which replace the Pallas
    _kcover_step_bwd_kernel; bound by bytes; no float atomics, so
    repeatable bit for bit). CPU tensor: `_kcover_step_bwd_plain`."""
    if not kbuf.is_cuda:
        return _kcover_step_bwd_plain(kbuf, cam, n_ty, n_tx, near, far,
                                      g_d, g_a)
    k_cover, m_out = _check_step_args(kbuf, cam)
    kernels.require(g_d, "g_d", (m_out,), device=kbuf.device)
    kernels.require(g_a, "g_a", (m_out,), device=kbuf.device)
    n_blocks = -(-m_out // kernels.REDUCE_THREADS)
    scratch = torch.empty((n_blocks, 12), dtype=F32, device=kbuf.device)
    out = torch.empty((12,), dtype=F32, device=kbuf.device)
    lib = kernels.load()
    err = lib.gsl_kcover_step_bwd(
        cam.data_ptr(), kbuf.data_ptr(), g_d.data_ptr(), g_a.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), k_cover, m_out, n_tx,
        float(near), float(far), n_blocks, kernels.stream_ptr())
    kernels.check(err, "kcover_step_bwd")
    kcover_step_bwd.launches += 1
    return out


kcover_step_bwd.launches = 0


class _RenderKcover(torch.autograd.Function):
    """K-cover render with the hand-written backward: forward saves
    (kbuf, cam); backward returns d_cam with slots 4..15 filled."""

    @staticmethod
    def forward(ctx, kbuf, cam, n_ty, n_tx, near, far):
        cam_c = cam.detach().contiguous()
        out = kcover_step_fwd(kbuf, cam_c, n_ty, n_tx, near, far)
        ctx.save_for_backward(kbuf, cam_c)
        ctx.dims = (n_ty, n_tx, near, far)
        return (unscramble_image(out[0], n_ty, n_tx),
                unscramble_image(out[1], n_ty, n_tx))

    @staticmethod
    def backward(ctx, gd_img, ga_img):
        kbuf, cam = ctx.saved_tensors
        n_ty, n_tx, near, far = ctx.dims
        g_d = scramble_image(gd_img, n_ty, n_tx).contiguous()
        g_a = scramble_image(ga_img, n_ty, n_tx).contiguous()
        d = kcover_step_bwd(kbuf, cam, n_ty, n_tx, near, far, g_d, g_a)
        return None, _d_cam(d), None, None, None, None


def render_kcover(kbuf, cam, n_ty: int, n_tx: int, near: float, far: float):
    """Depth+alpha render from a K-cover buffer, differentiable w.r.t. the
    cam vector (hand-written backward). Returns (depth_acc (hp, wp),
    alpha (hp, wp))."""
    return _RenderKcover.apply(kbuf, cam, n_ty, n_tx, near, far)


def render_tracking_depth_kcover(viewmat, K, width: int, height: int,
                                 kbuf, near: float = 1e-2,
                                 far: float = 1e10):
    """Normalized depth + alpha from a K-cover buffer, cropped to
    (height, width); differentiable w.r.t. viewmat."""
    from .binning import TILE_H, TILE_W

    n_ty = -(-height // TILE_H)
    n_tx = -(-width // TILE_W)
    cam = cam_vector(viewmat, K, width, height)
    d_acc, alpha = render_kcover(kbuf, cam, n_ty, n_tx, near, far)
    d_acc = d_acc[:height, :width]
    alpha = alpha[:height, :width]
    depth = d_acc / alpha.clamp_min(1e-10)
    return depth, alpha
