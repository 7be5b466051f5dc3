"""K-cover tracking renderer: per-pixel top-K splat lists.

With opacity-1 scenes each pixel's transmittance saturates after 2-3
covering splats, and between rebuilds the pose moves less than the
staleness budget the binning already rides, so the SET of splats covering
a pixel is as static as the tile assignment:

  1. SELECT (once per re-selection): walk the depth-sorted sub-tile
     segments of the slot buffer and emit for every pixel the 3D records
     [x, y, z, s2, opa] of its first K alpha hits, front to back, into a
     dense (NREC_KC=5, K, M_out) cover buffer (`build_kcover_buffer`:
     `select_kcover_records` directly, or `select_kcover`'s slot columns
     and a row gather, routed on K as in the JAX package).
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
  select_kcover          (csrc/kcover_select.cu) plain: _select_index_plain
      replaces the Pallas _kcover_select_kernel
(In this frozen copy each wrapper runs its plain version on any device;
the index select and its row gather are not on the reference's path.)

Selection semantics: liveness is exact per pixel (a pixel admits hits only
while its own transmittance is above T_EPS). The reference's TPU kernels
gate liveness per 256-slot block and may admit post-death hits into the
tail of a K-list; the render weighs those at <= T_EPS in total, so the two
buffers render alike to within T_EPS while their dead tails differ.
"""

from __future__ import annotations

import torch

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
# K3 / K8: the select, in its records and its index form
# ---------------------------------------------------------------------------

def _select_walk(p8, rows, fill, meta, n_ty, n_tx, k_cover, stats=None):
    """Plain PyTorch select walk, shared by both select forms, with the
    kernels' EXACT per-pixel semantics: every segment advances one slot per
    iteration (vectorized over segments and pixels); a pixel appends the
    slot's column of `rows` (R, B_pad) iff the slot's gated alpha (from the
    projected rows p8 (8, B_pad)) is > 0 while the pixel's own
    transmittance is > T_EPS and it holds fewer than K entries; entries it
    never fills hold `fill`. Reads the longest segment length (and a done
    flag every 64 slots) back to the host. stats (optional dict) receives
    the work this input needs: `pairs` ((slot, pixel) pairs met by a
    still-selecting pixel), `slots` (slots met by a sub-tile with at
    least one such pixel) and `seg_slots` ((n_seg,) int64: those slots of
    each segment, its first ones). Returns (R, K, M_out)."""
    dev = p8.device
    n_seg = n_ty * n_tx * N_SUB
    m_out = n_seg * P_SUB
    b_pad = p8.shape[1]
    n_rows = rows.shape[0]
    starts, ends = _segment_bounds(meta, n_seg)
    seg_len = ends - starts
    max_len = int(seg_len.max())
    x0, y0 = _segment_origins(meta, n_seg, n_tx)
    mono = _sub_mono(dev)
    out = torch.full((n_seg, k_cover, n_rows, P_SUB), fill, dtype=F32,
                     device=dev)
    t = torch.ones((n_seg, P_SUB), dtype=F32, device=dev)
    cnt = torch.zeros((n_seg, P_SUB), dtype=torch.int64, device=dev)
    n_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    seg_slots = torch.zeros((n_seg,), dtype=torch.int64, device=dev)
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
            seg_slots += sel.any(dim=1)
        rec = rows[:, idx].T  # (n_seg, R)
        index = cnt.clamp_max(k_cover - 1)[:, None, None, :].expand(
            n_seg, 1, n_rows, P_SUB)
        cur = out.gather(1, index)
        new = torch.where(hit[:, None, None, :],
                          rec[:, None, :, None].expand_as(cur), cur)
        out.scatter_(1, index, new)
        cnt = cnt + hit.to(torch.int64)
        t = torch.where(hit, t * (1.0 - alpha), t)
    if stats is not None:
        stats["pairs"] = int(n_pairs)
        stats["slots"] = int(seg_slots.sum())
        stats["seg_slots"] = seg_slots
    # (n_seg, K, R, P) -> (R, K, M_out)
    return out.permute(2, 1, 0, 3).reshape(n_rows, k_cover, m_out).contiguous()


def _select_records_plain(slot3d, meta, cam, n_ty, n_tx, k_cover, near, far,
                          stats=None):
    """Plain PyTorch records select: `_select_walk` over the slots projected
    with `cam`, emitting the 5 record rows (uncovered = zero record)."""
    p8 = _project8_rows(_project_slots(slot3d, cam), near, far)
    return _select_walk(p8, slot3d[:NREC_KC], 0.0, meta, n_ty, n_tx, k_cover,
                        stats)


def select_kcover_records(slot3d, meta, cam, n_ty: int, n_tx: int,
                          k_cover: int, near: float, far: float):
    """(NREC_KC, k_cover, M_out) f32: each pixel's first-K cover slot
    RECORDS (scrambled sub-tile-major pixel layout; uncovered = zero
    record), projected in-kernel from slot3d with `cam`.

    CUDA tensor: the hand-written kernel (csrc/kcover_select.cu, the
    records form of kcover_select_kernel, which replaces the Pallas
    _kcover_select_records_kernel; bound by bytes — one block per
    sub-tile, one thread per pixel, slots projected and boxed once while
    staged into shared memory, each warp walking only the slots whose
    footprint box meets its rows, every entry written once). CPU tensor:
    `_select_records_plain`."""
    return _select_records_plain(slot3d, meta, cam, n_ty, n_tx, k_cover,
                                 near, far)



def build_kcover_buffer(slot3d, meta, cam, n_ty: int, n_tx: int,
                        near: float, far: float, k_cover: int = 8):
    """Re-selection: each pixel's K cover records as a dense
    (NREC_KC, K, M_out) buffer through the records select (K3's plain
    form), the port's route for K*NREC_KC % 8 == 0 (K = 8, 16, 24, ...)."""
    if (k_cover * NREC_KC) % 8:
        raise ValueError(f"k_cover={k_cover}: the reference has the records "
                         "route only (K * 5 a multiple of 8)")
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


def _kcover_step_fwd_plain(kbuf, cam, n_ty, n_tx, near, far, row0_px=0.0):
    """Plain PyTorch K-cover step forward: (2, M_out) scrambled rows
    [depth_acc; alpha]. The transmittance and both sums run over the K
    axis in record order, one record at a time, as the kernel runs them
    (a record after the pixel's death adds w = 0)."""
    _pr, _ar, alpha, _ok, _lv, _te, _w, qz, _px, _py = _kcover_fwd_pieces(
        kbuf, cam, n_ty, n_tx, near, far, row0_px)
    return _step_totals(alpha, qz)


def _step_totals(alpha, qz):
    """(2, M_out) [depth_acc; alpha] of the gated (K, M_out) alphas and
    depths, summed over K in record order (the kernel's order)."""
    t = torch.ones_like(alpha[0])
    dacc = torch.zeros_like(t)
    aacc = torch.zeros_like(t)
    for k in range(alpha.shape[0]):
        om = 1.0 - alpha[k]
        w = torch.where(t * om > T_EPS, t * alpha[k], 0.0)
        dacc = dacc + w * qz[k]
        aacc = aacc + w
        t = t * om
    return torch.stack([dacc, aacc])


def _kcover_step_adjoint(kbuf, cam, n_ty, n_tx, near, far, g_d, g_a,
                         fwd=None, row0_px=0.0):
    """The compositing adjoint of the K-cover step per (record, pixel):
    returns (pr, d_sigma (K, M_out), qz_bar (K, M_out), px, py). g_d/g_a:
    (M_out,) scrambled cotangents; fwd: the forward's (2, M_out) rows
    [depth_acc; alpha], or None to total them here from the recomputed
    forward; row0_px: the band's first global pixel row.

    One sweep, as the kernel: the suffix sum of w*phi after record k is
    g_tot - (running sum through k), with g_tot = g_d*depth_acc +
    g_a*alpha. A record that is not live (the one whose inclusive
    transmittance crosses T_EPS, and every later one) has d_alpha 0: its
    exact suffix is 0, and the f32 suffix there is only the rounding
    residue of g_tot against the running sum."""
    pr, alpha_raw, alpha, ok, live, t_excl, w, qz, px, py = (
        _kcover_fwd_pieces(kbuf, cam, n_ty, n_tx, near, far, row0_px))
    if fwd is None:
        fwd = _step_totals(alpha, qz)
    g_tot = (g_d * fwd[0] + g_a * fwd[1])[None, :]
    g_d = g_d[None, :]
    g_a = g_a[None, :]

    # d_alpha_k = live_k * (t_excl_k * phi_k
    #                       - (sum_{j>k} phi_j w_j) / (1 - alpha_k))
    phi = g_d * qz + g_a
    suffix = g_tot - torch.cumsum(w * phi, dim=0)
    inv_om = 1.0 / torch.clamp_min(1.0 - alpha, 1.0 - ALPHA_MAX)
    d_alpha = torch.where(live, t_excl * phi, 0.0) - suffix * inv_om
    d_alpha = torch.where(ok & live & (alpha_raw < ALPHA_MAX), d_alpha, 0.0)
    return pr, d_alpha * (-alpha), w * g_d, px, py


def _kcover_step_bwd_plain(kbuf, cam, n_ty, n_tx, near, far, g_d, g_a,
                           fwd=None, row0_px=0.0):
    """Plain PyTorch hand-written backward to the pose: the compositing
    adjoint over the K axis (`_kcover_step_adjoint`, which takes g_d, g_a,
    fwd and row0_px), and the chain of d_sigma / the direct depth term to the pose
    with ONE `_pose_chain` call. Each record instance touches exactly one
    pixel, so its moment frame is that pixel itself (x0=px, y0=py): the
    only nonzero moment is m0 = d_sigma. Returns the 12 pose scalars
    [dR(9), dt(3)]."""
    _, k_cover, m_out = kbuf.shape
    pr, d_sigma, qz_bar, px, py = _kcover_step_adjoint(
        kbuf, cam, n_ty, n_tx, near, far, g_d, g_a, fwd, row0_px)
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


def _d_cam(d12):
    z = d12.new_zeros
    return torch.cat([z((4,)), d12[:12], z((2,))])


def kcover_step_fwd(kbuf, cam, n_ty, n_tx, near, far, row0_px=0.0):
    """K-cover step forward: (2, M_out) scrambled rows [depth_acc; alpha]
    of a band whose first global pixel row is row0_px (0: the whole
    image). CUDA tensor: the hand-written kernel (csrc/kcover_step.cu
    kcover_step_fwd_kernel, which replaces the Pallas
    _kcover_step_fwd_kernel; bound by bytes — one thread per pixel streams
    its K records, coalesced, and stops at a dead transmittance). CPU
    tensor: `_kcover_step_fwd_plain`."""
    return _kcover_step_fwd_plain(kbuf, cam, n_ty, n_tx, near, far,
                                  row0_px)


def kcover_step_bwd(kbuf, cam, n_ty, n_tx, near, far, g_d, g_a, fwd=None,
                    row0_px=0.0):
    """K-cover step backward: the 12 pose scalars [dR(9), dt(3)] from the
    scrambled cotangent rows g_d/g_a (M_out,) and the forward's (2, M_out)
    rows fwd [depth_acc; alpha] (`kcover_step_fwd` at the same camera and
    row0_px, the band's first global pixel row).
    CUDA tensor: the hand-written kernel pair (csrc/kcover_step.cu
    kcover_step_bwd_kernel + the fixed-order block reduction, which
    replace the Pallas _kcover_step_bwd_kernel; bound by bytes — one sweep
    reads each record once, the suffix sums taken from fwd; no float
    atomics, so repeatable bit for bit); fwd is required there. CPU tensor:
    `_kcover_step_bwd_plain` (which totals the forward itself when fwd is
    None)."""
    return _kcover_step_bwd_plain(kbuf, cam, n_ty, n_tx, near, far,
                                  g_d, g_a, fwd, row0_px)



class _RenderKcover(torch.autograd.Function):
    """K-cover render with the hand-written backward: forward saves
    (kbuf, cam, its (2, M_out) rows); backward returns d_cam with slots
    4..15 filled."""

    @staticmethod
    def forward(ctx, kbuf, cam, n_ty, n_tx, near, far, row0_px):
        cam_c = cam.detach().contiguous()
        out = kcover_step_fwd(kbuf, cam_c, n_ty, n_tx, near, far, row0_px)
        ctx.save_for_backward(kbuf, cam_c, out)
        ctx.dims = (n_ty, n_tx, near, far, row0_px)
        return (unscramble_image(out[0], n_ty, n_tx),
                unscramble_image(out[1], n_ty, n_tx))

    @staticmethod
    def backward(ctx, gd_img, ga_img):
        kbuf, cam, out = ctx.saved_tensors
        n_ty, n_tx, near, far, row0_px = ctx.dims
        g_d = scramble_image(gd_img, n_ty, n_tx).contiguous()
        g_a = scramble_image(ga_img, n_ty, n_tx).contiguous()
        d = kcover_step_bwd(kbuf, cam, n_ty, n_tx, near, far, g_d, g_a, out,
                            row0_px)
        return None, _d_cam(d), None, None, None, None, None


def render_kcover(kbuf, cam, n_ty: int, n_tx: int, near: float, far: float,
                  row0_px=0.0):
    """Depth+alpha render from a K-cover buffer, differentiable w.r.t. the
    cam vector (hand-written backward). row0_px: the global y of the
    buffer's first pixel row (nonzero for a band of a tile mesh,
    parallel/sharded.py). Returns (depth_acc (hp, wp), alpha (hp, wp))."""
    return _RenderKcover.apply(kbuf, cam, n_ty, n_tx, near, far,
                               float(row0_px))


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
