"""Sub-tile tracking rasterizer: (16, 16) pixel sub-tiles.

Same math and gating as the K-cover render, evaluated by WALKING each
sub-tile's depth-sorted slot segment: project every slot once
(`project8`), then composite front to back per pixel with a transmittance
early stop (`subtile_fwd`). It renders the depth target of a frame pair
(data/parser.py render_depth_gt) and, differentiable w.r.t. the camera, is
the per-step render of the `kcover=0` tracking path: the backward replays
the walk and emits per-slot pixel moments of d_sigma (`subtile_bwd`), and
a per-slot pass chains those moments to the 12 pose partials
(`subtile_chain`).

Sub-tile layout: the image is padded to (16, 128) macro tiles; each macro
tile holds N_SUB = 8 sub-tiles of 16x16 pixels. Sub-tile segments are
numbered global-row-major over the image, per-sub-tile pixels are
flattened r*SUB_W + c, and a flat "scrambled" image holds sub-tile `st` at
[st*P_SUB, (st+1)*P_SUB); (H, W) is recovered by unscramble_image.
Segments are padded to CHUNK multiples (pad_to_chunks), so every 128-slot
chunk belongs to exactly one sub-tile and the backward can bin moments per
chunk in that sub-tile's tile-local frame.

Kernels (csrc/subtile_fwd.cu, csrc/subtile_bwd.cu), each with its plain
PyTorch version here:
  project8      replaces the Pallas _project8_kernel     plain: _project8
  subtile_fwd   replaces the Pallas _subtile_fwd_kernel  plain: _subtile_fwd_plain
  subtile_bwd   replaces the Pallas _subtile_bwd_kernel  plain: _subtile_bwd_plain
  subtile_chain replaces the Pallas _chain_kernel        plain: _chain_xla
"""

from __future__ import annotations

import torch

from .. import kernels
from .._device import F32
from .binning import TILE_H, TILE_W, bin_and_sort
from .fused_tracking import (
    NUM_ISO_ROWS,
    _pose_chain,
    _project8_rows,
    _project_slots,
    cam_vector,
)

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
T_EPS = 1e-4
CHUNK = 128  # slots per walk chunk (the unit `chunks done` counts in)

SUB_W = 16
SUB_H = 16
KX_SUB = 2
KY_SUB = 2
N_SUB_X = TILE_W // SUB_W
N_SUB_Y = TILE_H // SUB_H
N_SUB = N_SUB_Y * N_SUB_X  # sub-tiles per macro tile
P_SUB = SUB_H * SUB_W  # pixels per sub-tile
NUM_PROJ_ROWS = 8  # [u, v, ca, cb, cc, qz, opa, ok]
CB = 8192  # static slot-buffer length alignment

# fp-noise slack for the (analytically >= 0) expanded sigma polynomial:
# the expansion recombines terms up to ~1e3 in magnitude, so sigma == 0 at
# a splat centre can come back a few 1e-4 negative.
SIG_EPS = 1e-2
ENC_Y = 4096.0  # moment row 7 packs the sub-tile origin: sub_row*ENC_Y + sub_col


def _sub_mono(device):
    """Tile-LOCAL monomial basis (6, P_SUB) [1, x, y, x^2, xy, y^2] at the
    sub-tile pixel centres, flattened r*SUB_W+c. Local coords are
    (col + 0.5, row + 0.5) — identical for every sub-tile."""
    flat = torch.arange(P_SUB, device=device)[None, :]
    yl = (flat // SUB_W).to(F32) + 0.5
    xl = (flat % SUB_W).to(F32) + 0.5
    return torch.cat(
        [torch.ones((1, P_SUB), dtype=F32, device=device), xl, yl,
         xl * xl, xl * yl, yl * yl],
        dim=0,
    )


def _coeff_mat(rec8, x0, y0):
    """(8, C) pre-projected slots -> (C, 8) per-slot columns: 0-5 the
    TILE-LOCAL sigma polynomial coefficients [c0, cx, cy, cxx, cxy, cyy],
    6 qz, 7 the validity-folded opacity (opa * ok). x0/y0: scalars or (1, C)
    rows (the sub-tile origin each slot is evaluated against).

    sigma = 0.5*(ca*dx^2 + cc*dy^2) + cb*dx*dy with dx = px - u expands
    exactly into a quadratic in the tile-local pixel coords (global coords
    would lose ~5 of 7 fp32 digits to cancellation)."""
    u, v = rec8[0:1, :], rec8[1:2, :]
    ca, cb, cc = rec8[2:3, :], rec8[3:4, :], rec8[4:5, :]
    ul = u - x0
    vl = v - y0
    c0 = 0.5 * (ca * ul * ul + cc * vl * vl) + cb * ul * vl
    cx = -(ca * ul + cb * vl)
    cy = -(cc * vl + cb * ul)
    mat = torch.cat(
        [c0, cx, cy, 0.5 * ca, cb, 0.5 * cc, rec8[5:6, :],
         rec8[6:7, :] * rec8[7:8, :]],
        dim=0,
    )  # (8, C)
    return mat.T  # (C, 8)


def _sub_alpha(mat, mono):
    """Gated alpha (C, P_SUB): sigma as six broadcast multiply-adds of the
    (C, 1) coefficient columns against the (1, P_SUB) monomial rows, in
    true f32 (terms up to ~1e3 recombine to O(1))."""
    sigma = (mat[:, 0:1]
             + mat[:, 1:2] * mono[1:2] + mat[:, 2:3] * mono[2:3]
             + mat[:, 3:4] * mono[3:4] + mat[:, 4:5] * mono[4:5]
             + mat[:, 5:6] * mono[5:6])  # (C, P_SUB)
    alpha = torch.clamp_max(mat[:, 7:8] * torch.exp(-sigma), ALPHA_MAX)
    ok = (sigma >= -SIG_EPS) & (alpha >= ALPHA_MIN)
    return torch.where(ok, alpha, 0.0)


def _seg_id(ti_global, tj, n_tx, s):
    """Global-ROW-MAJOR sub-tile segment id for sub-walk s of macro tile
    (ti, tj)."""
    ry = s // N_SUB_X
    cx = s % N_SUB_X
    return (ti_global * N_SUB_Y + ry) * (n_tx * N_SUB_X) + tj * N_SUB_X + cx


def _sub_origin(ti_global, tj, s):
    """(x0, y0) pixel origin of sub-walk s's tile-local monomial frame."""
    ry = s // N_SUB_X
    cx = s % N_SUB_X
    x0 = float((tj * N_SUB_X + cx) * SUB_W)
    y0 = float((ti_global * N_SUB_Y + ry) * SUB_H)
    return x0, y0


def _segment_origins(meta, n_seg, n_tx):
    """(n_seg,) x0, y0 of every sub-tile segment (global row-major ids)."""
    seg = torch.arange(n_seg, device=meta.device)
    n_gx = n_tx * N_SUB_X
    x0 = ((seg % n_gx) * SUB_W).to(F32)
    y0 = ((meta[0] * N_SUB_Y + seg // n_gx) * SUB_H).to(F32)
    return x0, y0


def scramble_image(img, n_ty, n_tx):
    """(hp, wp) image -> flat sub-tile-major layout (n_ty*n_tx*N_SUB*P_SUB,):
    element [(gy*n_gx + gx)*P_SUB + r*SUB_W + c] = img[gy*SUB_H+r, gx*SUB_W+c]."""
    n_gy, n_gx = n_ty * N_SUB_Y, n_tx * N_SUB_X
    return (
        img.reshape(n_gy, SUB_H, n_gx, SUB_W)
        .permute(0, 2, 1, 3)
        .reshape(-1)
    )


def unscramble_image(flat, n_ty, n_tx):
    """Inverse of scramble_image: flat sub-tile-major -> (hp, wp)."""
    n_gy, n_gx = n_ty * N_SUB_Y, n_tx * N_SUB_X
    return (
        flat.reshape(n_gy, n_gx, SUB_H, SUB_W)
        .permute(0, 2, 1, 3)
        .reshape(n_gy * SUB_H, n_gx * SUB_W)
    )


def iso_records(scene):
    """(N + 1, 8) isotropic slot records [x, y, z, s2, opa, 0, 0, 0] with a
    trailing all-zero dummy row (opacity 0 -> alpha gated off) for dead
    padding slots."""
    n = scene.means.shape[0]
    rec = torch.zeros((n + 1, NUM_ISO_ROWS), dtype=F32,
                      device=scene.means.device)
    rec[:n, 0:3] = scene.means
    rec[:n, 3] = scene.scales[:, 0] * scene.scales[:, 0]
    rec[:n, 4] = scene.opacities
    return rec


def build_subtile_slot_buffer(scene, viewmat, K, width: int, height: int,
                              near: float, far: float, big_budget: int = 64):
    """Project with the given pose, bin at (16, SUB_W) sub-tile granularity
    with CHUNK-ALIGNED segments (pad_to_chunks) and gather the pose-
    independent 3D slot buffer (8, M_pad) + meta. Dead padding slots point
    at an appended zero-opacity dummy record. big_budget: exact full-
    footprint binning for the top-B biggest splats (ops/binning.py).
    Assumes the isotropic-scene contract (ops/fused_tracking.py)."""
    from .projection import project_gaussians

    n_tx = -(-width // TILE_W)
    proj = project_gaussians(
        scene.means, scene.quats, scene.scales, viewmat, K, width, height,
        near, far,
    )
    # bin over the PADDED image extent so the sub-tile grid matches the
    # kernel grid exactly
    n_ty = -(-height // TILE_H)
    binning = bin_and_sort(
        proj.mean2d, proj.radius, proj.depth, proj.valid,
        n_tx * TILE_W, n_ty * TILE_H,
        tile_h=SUB_H, tile_w=SUB_W, ky=KY_SUB, kx=KX_SUB, chunk=CHUNK,
        needs_inv_perm=False,
        big_budget=big_budget, pad_to_chunks=True, pad_align=CB,
    )
    records = iso_records(scene)
    slot3d = records[binning.pair_gauss.long()].T.contiguous()  # (8, Mp)
    meta = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=slot3d.device),
        binning.tile_starts,
    ])
    return slot3d.detach(), meta, binning


# ---------------------------------------------------------------------------
# K4a: projection phase
# ---------------------------------------------------------------------------

def _project8(slot3d, cam, near, far):
    """Plain PyTorch projection phase: (8, M) iso slot buffer -> (8, M) rows
    [u, v, ca, cb, cc, qz, opa, ok]. The dummy record (all zeros) projects
    to opa = 0 with finite conics."""
    return _project8_rows(_project_slots(slot3d, cam), near, far)


def project8(slot3d, cam, near, far):
    """Projection phase over the whole slot buffer. CUDA tensor: the
    hand-written kernel (csrc/subtile_fwd.cu project8_kernel, which
    replaces the Pallas _project8_kernel; bound by bytes — one thread per
    slot, coalesced rows). CPU tensor: the plain version `_project8`."""
    if not slot3d.is_cuda:
        return _project8(slot3d, cam, near, far)
    mp = slot3d.shape[1]
    kernels.require(slot3d, "slot3d", (NUM_ISO_ROWS, mp))
    kernels.require_cam(cam, slot3d.device)
    out = torch.empty((NUM_PROJ_ROWS, mp), dtype=F32, device=slot3d.device)
    lib = kernels.load()
    err = lib.gsl_project8(cam.data_ptr(), slot3d.data_ptr(), out.data_ptr(),
                           mp, float(near), float(far), kernels.stream_ptr())
    kernels.check(err, "project8")
    project8.launches += 1
    return out


project8.launches = 0


# ---------------------------------------------------------------------------
# K4b: compositing walk
# ---------------------------------------------------------------------------

def _segment_bounds(meta, n_seg):
    starts = meta[1:1 + n_seg].long()
    ends = meta[2:2 + n_seg].long()
    return starts, ends


def _chunk_alpha(proj8, base, xa, ya, mono):
    """Gated alpha (n, CHUNK, P_SUB) and qz (n, CHUNK, 1) of one 128-slot
    chunk of each of n segments (first slots `base`, origins xa/ya (n,)),
    and the number of live (opacity * ok != 0) slots among them. Alpha does
    not depend on the transmittance, so the whole chunk is evaluated at
    once; only the recurrence along the slots is sequential."""
    n = base.shape[0]
    idx = (base[:, None] + torch.arange(CHUNK, device=base.device)).reshape(-1)
    mat = _coeff_mat(proj8[:, idx], xa.repeat_interleave(CHUNK)[None, :],
                     ya.repeat_interleave(CHUNK)[None, :])
    alpha = _sub_alpha(mat, mono).reshape(n, CHUNK, P_SUB)
    return alpha, mat[:, 6].reshape(n, CHUNK, 1), int((mat[:, 7] != 0).sum())


def _subtile_fwd_plain(proj8, meta, n_ty, n_tx, stats=None):
    """Plain PyTorch sub-tile walk: chunk by chunk, the segments still alive
    at the chunk's entry advance one slot per iteration together
    (vectorized over those segments and their pixels, sequential along
    depth order — the same per-pixel recurrence and the same operation
    order as the kernel). Returns (out (2, M_out) [depth_acc; alpha],
    chunks_done (n_seg,) int32). Reads the number of live segments back to
    the host once per chunk. stats (optional dict) receives `pairs`: the
    (live slot, pixel) pairs the walked chunks hold — the work this input
    needs."""
    dev = proj8.device
    n_seg = n_ty * n_tx * N_SUB
    starts, ends = _segment_bounds(meta, n_seg)
    seg_chunks = (ends - starts) // CHUNK
    x0, y0 = _segment_origins(meta, n_seg, n_tx)
    mono = _sub_mono(dev)
    t = torch.ones((n_seg, P_SUB), dtype=F32, device=dev)
    dacc = torch.zeros_like(t)
    aacc = torch.zeros_like(t)
    cd = torch.zeros((n_seg,), dtype=torch.int32, device=dev)
    live_slots = 0
    for c in range(int(seg_chunks.max())):
        # chunk-granular early stop, as the kernel: a chunk is walked iff
        # some pixel of the sub-tile is still alive at its entry
        act = torch.nonzero(
            (t.max(dim=1).values > T_EPS) & (c < seg_chunks))[:, 0]
        if act.numel() == 0:
            break
        cd[act] += 1
        ta, da, aa = t[act], dacc[act], aacc[act]
        alpha, qz, n_live = _chunk_alpha(proj8, starts[act] + c * CHUNK,
                                         x0[act], y0[act], mono)
        live_slots += n_live
        for jj in range(CHUNK):
            a = alpha[:, jj]
            t_incl = ta * (1.0 - a)
            w = torch.where(t_incl > T_EPS, ta * a, 0.0)
            da = da + qz[:, jj] * w
            aa = aa + w
            ta = t_incl
        t[act], dacc[act], aacc[act] = ta, da, aa
    if stats is not None:
        stats["pairs"] = live_slots * P_SUB
    out = torch.stack([dacc.reshape(-1), aacc.reshape(-1)])
    return out, cd


def subtile_fwd(proj8, meta, n_ty, n_tx):
    """Front-to-back compositing of every sub-tile's chunk-padded segment.
    Returns (out (2, M_out) scrambled rows [depth_acc; alpha], chunks_done
    (n_seg,) int32 in 128-slot chunks). CUDA tensor: the hand-written
    kernel (csrc/subtile_fwd.cu subtile_fwd_kernel, which replaces the
    Pallas _subtile_fwd_kernel; bound by operations — one block per
    sub-tile, one thread per pixel, chunks staged in shared memory). CPU
    tensor: the plain version `_subtile_fwd_plain`."""
    if not proj8.is_cuda:
        return _subtile_fwd_plain(proj8, meta, n_ty, n_tx)
    n_seg = n_ty * n_tx * N_SUB
    m_out = n_seg * P_SUB
    mp = proj8.shape[1]
    kernels.require(proj8, "proj8", (NUM_PROJ_ROWS, mp))
    kernels.require(meta, "meta", (n_seg + 2,), dtype=torch.int32,
                    device=proj8.device)
    if mp % CHUNK:
        raise ValueError(f"proj8 length {mp} is not a multiple of {CHUNK}")
    out = torch.empty((2, m_out), dtype=F32, device=proj8.device)
    cd = torch.empty((n_seg,), dtype=torch.int32, device=proj8.device)
    lib = kernels.load()
    err = lib.gsl_subtile_fwd(meta.data_ptr(), proj8.data_ptr(),
                              out.data_ptr(), cd.data_ptr(), n_seg, mp,
                              m_out, n_tx, kernels.stream_ptr())
    kernels.check(err, "subtile_fwd")
    subtile_fwd.launches += 1
    return out, cd


subtile_fwd.launches = 0


# ---------------------------------------------------------------------------
# K5a: alpha replay + compositing adjoint -> per-slot pixel moments
# ---------------------------------------------------------------------------

def _segment_enc(meta, n_seg, n_tx):
    """(n_seg,) f32 packed sub-tile origin of every segment:
    global_sub_row*ENC_Y + global_sub_col (exact in f32)."""
    seg = torch.arange(n_seg, device=meta.device)
    n_gx = n_tx * N_SUB_X
    row = meta[0].long() * N_SUB_Y + seg // n_gx
    return (row * int(ENC_Y) + seg % n_gx).to(F32)


def _subtile_bwd_plain(proj8, sin, meta, n_ty, n_tx, stats=None):
    """Plain PyTorch backward walk: the forward recurrence replayed per
    (segment, pixel) in the same chunk-by-chunk form as
    `_subtile_fwd_plain`, with the compositing adjoint of the reference's
    _subtile_bwd_kernel:

      phi = g_d*qz + g_a;  s_incl = running sum of w*phi;
      suffix = g_tot - s_incl  with g_tot = g_d*depth_acc + g_a*alpha;
      d_alpha = t_prefix*phi - suffix / max(1 - alpha, 1 - ALPHA_MAX),
                gated by live & alpha > 0, and 0 at alpha >= ALPHA_MAX;
      d_sigma = -alpha*d_alpha.

    sin: (4, M_out) scrambled pixel rows [depth_acc, alpha, g_d, g_a] (the
    forward totals and the two cotangents). Returns mom (8, M_pad): rows 0-5
    the tile-local moments of d_sigma over the sub-tile's pixels
    [1, x, y, x^2, xy, y^2], row 6 the direct depth term sum_p w*g_d, row 7
    the packed sub-tile origin (`_segment_enc`). Every slot of a chunk the
    early stop skips, and every slot outside [meta[1], meta[-1]), is 0 in
    all 8 rows. stats (optional dict) receives `pairs`, the (live slot,
    pixel) pairs of the walked chunks."""
    dev = proj8.device
    n_seg = n_ty * n_tx * N_SUB
    m_pad = proj8.shape[1]
    starts, ends = _segment_bounds(meta, n_seg)
    seg_chunks = (ends - starts) // CHUNK
    x0, y0 = _segment_origins(meta, n_seg, n_tx)
    enc = _segment_enc(meta, n_seg, n_tx)
    mono_t = _sub_mono(dev).T.contiguous()  # (P_SUB, 6)
    px = sin.reshape(4, n_seg, P_SUB)
    g_d, g_a = px[2], px[3]
    g_tot = g_d * px[0] + g_a * px[1]
    t = torch.ones((n_seg, P_SUB), dtype=proj8.dtype, device=dev)
    run = torch.zeros_like(t)
    mom = torch.zeros((NUM_PROJ_ROWS, m_pad), dtype=F32, device=dev)
    live_slots = 0
    for c in range(int(seg_chunks.max())):
        act = torch.nonzero(
            (t.max(dim=1).values > T_EPS) & (c < seg_chunks))[:, 0]
        if act.numel() == 0:
            break
        ta, ra = t[act], run[act]
        gda, gaa, gta = g_d[act], g_a[act], g_tot[act]
        base = starts[act] + c * CHUNK
        alpha, qz, n_live = _chunk_alpha(proj8, base, x0[act], y0[act],
                                         mono_t.T)
        live_slots += n_live
        ds = torch.empty_like(alpha)
        wg = torch.empty_like(alpha)
        for jj in range(CHUNK):
            a = alpha[:, jj]
            one_minus = 1.0 - a
            t_incl = ta * one_minus
            live = t_incl > T_EPS
            w = torch.where(live, ta * a, 0.0)
            phi = gda * qz[:, jj] + gaa
            ra = ra + w * phi
            suffix = gta - ra
            inv_om = 1.0 / torch.clamp_min(one_minus, 1.0 - ALPHA_MAX)
            d_alpha = ta * phi - suffix * inv_om
            d_alpha = torch.where(live & (a > 0.0), d_alpha, 0.0)
            d_alpha = torch.where(a >= ALPHA_MAX, 0.0, d_alpha)
            ds[:, jj] = d_alpha * (-a)
            wg[:, jj] = w * gda
            ta = t_incl
        idx = (base[:, None] + torch.arange(CHUNK, device=dev)).reshape(-1)
        mom[0:6, idx] = (ds @ mono_t.to(ds.dtype)).reshape(-1, 6).T.to(F32)
        mom[6, idx] = wg.sum(dim=2).reshape(-1).to(F32)
        mom[7, idx] = enc[act].repeat_interleave(CHUNK)
        t[act], run[act] = ta, ra
    if stats is not None:
        stats["pairs"] = live_slots * P_SUB
    return mom


def subtile_bwd(proj8, sin, meta, n_ty, n_tx):
    """Per-slot pixel moments of the sub-tile walk's adjoint (see
    `_subtile_bwd_plain` for the rows). CUDA tensor: the hand-written kernel
    (csrc/subtile_bwd.cu subtile_bwd_kernel, which replaces the Pallas
    _subtile_bwd_kernel; bound by operations — one block per sub-tile, one
    thread per pixel, chunks staged in shared memory, moments summed per
    slot in a fixed order without atomics). CPU tensor: the plain version
    `_subtile_bwd_plain`."""
    if not proj8.is_cuda:
        return _subtile_bwd_plain(proj8, sin, meta, n_ty, n_tx)
    n_seg = n_ty * n_tx * N_SUB
    m_out = n_seg * P_SUB
    mp = proj8.shape[1]
    kernels.require(proj8, "proj8", (NUM_PROJ_ROWS, mp))
    kernels.require(sin, "sin", (4, m_out), device=proj8.device)
    kernels.require(meta, "meta", (n_seg + 2,), dtype=torch.int32,
                    device=proj8.device)
    if mp % CHUNK:
        raise ValueError(f"proj8 length {mp} is not a multiple of {CHUNK}")
    mom = torch.empty((NUM_PROJ_ROWS, mp), dtype=F32, device=proj8.device)
    lib = kernels.load()
    err = lib.gsl_subtile_bwd(meta.data_ptr(), proj8.data_ptr(),
                              sin.data_ptr(), mom.data_ptr(), n_seg, mp,
                              m_out, n_tx, kernels.stream_ptr())
    kernels.check(err, "subtile_bwd")
    subtile_bwd.launches += 1
    return mom


subtile_bwd.launches = 0


# ---------------------------------------------------------------------------
# K5b: moments -> 12 pose partials
# ---------------------------------------------------------------------------

def _chain_xla(slot3d, mom, cam, meta, n_tx):
    """Plain PyTorch pose chain: per-slot moments -> (1, 16) pose partial
    row [dR(9), dt(3), 0, 0, 0, 0]. `_pose_chain` is linear in the moments,
    so masking them to the walked slot range [meta[1], meta[-1]) masks the
    contributions exactly. Each slot's sub-tile origin — the frame its
    moments were binned in — is reconstructed from the segment offsets:
    segments are CHUNK-aligned, so one searchsorted over chunk starts gives
    the chunk -> segment map."""
    mp = slot3d.shape[1]
    n_chunks = mp // CHUNK
    n_seg = meta.shape[0] - 2
    dev = slot3d.device
    cstart = torch.arange(n_chunks, device=dev, dtype=torch.int32) * CHUNK
    seg = torch.searchsorted(meta[2:].contiguous(), cstart, right=True)
    seg = seg.clamp(0, n_seg - 1)
    n_gx = n_tx * N_SUB_X
    x0c = ((seg % n_gx) * SUB_W).to(F32)
    y0c = ((meta[0].long() * N_SUB_Y + seg // n_gx) * SUB_H).to(F32)
    x0 = x0c[:, None].expand(n_chunks, CHUNK).reshape(1, -1)
    y0 = y0c[:, None].expand(n_chunks, CHUNK).reshape(1, -1)
    idx = torch.arange(mp, device=dev)
    mask = ((idx >= meta[1]) & (idx < meta[-1]))[None, :]
    momz = torch.where(mask, mom, 0.0)
    pr = _project_slots(slot3d, cam)
    return _pose_chain(
        pr,
        momz[0:1], momz[1:2], momz[2:3], momz[3:4], momz[4:5], momz[5:6],
        momz[6:7],
        x0, y0, cam[0], cam[1],
    )


def subtile_chain(slot3d, mom, cam, meta, n_tx):
    """(1, 16) pose partial row [dR(9), dt(3), 0, 0, 0, 0] from the
    per-slot moments. CUDA tensor: the hand-written kernel
    (csrc/subtile_bwd.cu subtile_chain_kernel, which replaces the Pallas
    _chain_kernel; bound by bytes — one thread per slot decodes its origin
    from moment row 7, recomputes the projection and runs the pose chain;
    the 12 partials are reduced warp -> block -> (n_blocks, 12) scratch ->
    fixed-order double sum, shared with the K-cover step backward). CPU
    tensor: the plain version `_chain_xla`."""
    if not slot3d.is_cuda:
        return _chain_xla(slot3d, mom, cam, meta, n_tx)
    mp = slot3d.shape[1]
    kernels.require(slot3d, "slot3d", (NUM_ISO_ROWS, mp))
    kernels.require(mom, "mom", (NUM_PROJ_ROWS, mp), device=slot3d.device)
    kernels.require(meta, "meta", (meta.shape[0],), dtype=torch.int32,
                    device=slot3d.device)
    kernels.require_cam(cam, slot3d.device)
    n_blocks = -(-mp // kernels.REDUCE_THREADS)
    scratch = torch.empty((n_blocks, 12), dtype=F32, device=slot3d.device)
    out = torch.zeros((1, 16), dtype=F32, device=slot3d.device)
    lib = kernels.load()
    err = lib.gsl_subtile_chain(cam.data_ptr(), slot3d.data_ptr(),
                                mom.data_ptr(), meta.data_ptr(),
                                scratch.data_ptr(), out.data_ptr(),
                                meta.shape[0] - 2, mp, n_blocks,
                                kernels.stream_ptr())
    kernels.check(err, "subtile_chain")
    subtile_chain.launches += 1
    return out


subtile_chain.launches = 0


class _SubtileRender(torch.autograd.Function):
    """Depth + alpha render from a sub-tile slot buffer, differentiable
    w.r.t. the cam vector only: forward project8 -> subtile_fwd; backward
    subtile_bwd -> subtile_chain."""

    @staticmethod
    def forward(ctx, slot3d, meta, cam, n_ty, n_tx, near, far):
        cam = cam.detach().contiguous()
        proj8 = project8(slot3d, cam, near, far)
        out, _cd = subtile_fwd(proj8, meta, n_ty, n_tx)
        ctx.save_for_backward(slot3d, proj8, meta, cam, out)
        ctx.grid = (n_ty, n_tx)
        return (unscramble_image(out[0], n_ty, n_tx),
                unscramble_image(out[1], n_ty, n_tx))

    @staticmethod
    def backward(ctx, g_dacc, g_alpha):
        slot3d, proj8, meta, cam, out = ctx.saved_tensors
        n_ty, n_tx = ctx.grid
        sin = torch.stack([
            out[0], out[1],
            scramble_image(g_dacc.to(F32), n_ty, n_tx),
            scramble_image(g_alpha.to(F32), n_ty, n_tx),
        ]).contiguous()  # (4, M_out)
        mom = subtile_bwd(proj8, sin, meta, n_ty, n_tx)
        d = subtile_chain(slot3d, mom, cam, meta, n_tx)
        zero = torch.zeros((2,), dtype=F32, device=cam.device)
        d_cam = torch.cat([zero, zero, d[0, :12], zero])
        return None, None, d_cam, None, None, None, None


def subtile_render(slot3d, meta, cam, n_ty, n_tx, m_pad, near, far):
    """Depth+alpha render from a sub-tile slot buffer, differentiable w.r.t.
    the cam vector only. Returns (depth_acc (hp, wp), alpha (hp, wp))."""
    return _SubtileRender.apply(slot3d, meta, cam, n_ty, n_tx, near, far)


def render_tracking_depth_subtile(viewmat, K, width: int, height: int,
                                  slot3d, meta, near: float = 1e-2,
                                  far: float = 1e10):
    """Normalized depth + alpha from a prebuilt sub-tile slot buffer,
    cropped to (height, width); differentiable w.r.t. viewmat."""
    n_ty = -(-height // TILE_H)
    n_tx = -(-width // TILE_W)
    m_pad = slot3d.shape[1]
    cam = cam_vector(viewmat, K, width, height)
    d_acc, alpha = subtile_render(
        slot3d, meta, cam, n_ty, n_tx, m_pad, near, far
    )
    d_acc = d_acc[:height, :width]
    alpha = alpha[:height, :width]
    depth = d_acc / alpha.clamp_min(1e-10)
    return depth, alpha
