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

from .._device import F32
from .binning import TILE_H, TILE_W, bin_and_sort
from .fused_tracking import (
    NUM_ISO_ROWS,
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
# footprint-box rounding margins (the port's ops/rasterize_tiles.py)
BOX_DET_REL = 2.0 ** -20
BOX_L_REL = 2.0 ** -20
BOX_REL = 2.0 ** -16

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


# margins of the sub-tile footprint box (csrc/subtile.cuh, where they are
# argued); BOX_DET_REL, BOX_L_REL and BOX_REL are the tile walks' own
SUB_BOX_ERR_REL = 2.0 ** -18
SUB_BOX_ERR_ABS = 2.0 ** -20
SUB_BOX_ERR_MAX = 0.25


def _subtile_box(coef, ul, vl):
    """Sub-tile-local pixel box (c_lo, c_hi, r_lo, r_hi), inclusive and
    clamped to the 16x16 sub-tile, of each slot's alpha-gate footprint:
    every pixel centre outside it gets alpha 0 from `_sub_alpha`. The plain
    form of csrc/subtile.cuh subtile_box, in its f32 operation order (the
    margins and the cases are argued there). coef: (..., 8) `_coeff_mat`
    columns [c0, cx, cy, cxx, cxy, cyy, qz, opa*ok]; ul, vl: (...) the
    slots' u - x0 and v - y0 in f32. An empty box is (SUB_W, -1, SUB_H,
    -1), the whole sub-tile (0, SUB_W - 1, 0, SUB_H - 1). Returns four
    int64 tensors of ul's shape."""
    c0, cx, cy = coef[..., 0], coef[..., 1], coef[..., 2]
    cxx, cxy, cyy, opa = coef[..., 3], coef[..., 4], coef[..., 5], coef[..., 7]
    finite = (torch.isfinite(c0) & torch.isfinite(cx) & torch.isfinite(cy)
              & torch.isfinite(cxx) & torch.isfinite(cxy)
              & torch.isfinite(cyy) & torch.isfinite(opa)
              & torch.isfinite(ul) & torch.isfinite(vl))
    k1 = 4.0 * (cxx * cyy)
    det_lo = (k1 - cxy * cxy) - k1 * BOX_DET_REL
    pd = (cxx > 0.0) & (cyy > 0.0) & (det_lo > 0.0)
    au, av, axy = ul.abs(), vl.abs(), cxy.abs()
    mag = (c0.abs() + 16.0 * (cx.abs() + cy.abs())
           + 256.0 * (cxx + axy + cyy)
           + (cxx * (au * au) + cyy * (av * av) + axy * (au * av))
           + 16.0 * ((2.0 * cxx) * au + (2.0 * cyy) * av + axy * (au + av)))
    err = mag * SUB_BOX_ERR_REL + SUB_BOX_ERR_ABS
    small = err <= SUB_BOX_ERR_MAX
    lf = torch.log(opa * 255.0)
    s = (lf + lf.abs() * BOX_L_REL + BOX_L_REL) + err
    s4 = (4.0 * s) / det_lo
    hx = torch.sqrt(s4 * cyy)
    hy = torch.sqrt(s4 * cxx)
    ex = hx + hx * BOX_REL + (au + 1.0) * BOX_REL
    ey = hy + hy * BOX_REL + (av + 1.0) * BOX_REL
    # fmaxf / fminf keep the number when the other operand is NaN
    c_lo = torch.fmax(torch.ceil(ul - ex - 0.5), torch.zeros_like(ul))
    c_hi = torch.fmin(torch.floor(ul + ex - 0.5),
                      torch.full_like(ul, SUB_W - 1))
    r_lo = torch.fmax(torch.ceil(vl - ey - 0.5), torch.zeros_like(vl))
    r_hi = torch.fmin(torch.floor(vl + ey - 0.5),
                      torch.full_like(vl, SUB_H - 1))
    whole_t = torch.tensor([0, SUB_W - 1, 0, SUB_H - 1], device=ul.device)
    empty_t = torch.tensor([SUB_W, -1, SUB_H, -1], device=ul.device)
    box = (s >= 0.0) & (c_lo <= c_hi) & (r_lo <= r_hi)
    out = torch.stack([c_lo, c_hi, r_lo, r_hi], dim=-1)
    out = torch.where(box[..., None], out.long(), empty_t)
    # the kernel's cases, the first that holds deciding: applied here from
    # the last to the first
    for case, val in ((~small, whole_t), (~pd, whole_t), (opa < 0.0, empty_t),
                      (~finite, whole_t), (opa == 0.0, empty_t)):
        out = torch.where(case[..., None], val, out)
    return out.unbind(-1)


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
    return _project8(slot3d, cam, near, far)



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
    Pallas _subtile_fwd_kernel; bound by bytes — one block per sub-tile,
    one thread per pixel, chunks staged and boxed in shared memory, each
    warp walking only the slots whose footprint box meets its rows). CPU
    tensor: the plain version `_subtile_fwd_plain`."""
    return _subtile_fwd_plain(proj8, meta, n_ty, n_tx)



# ---------------------------------------------------------------------------
# K5a: alpha replay + compositing adjoint -> per-slot pixel moments
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# K5b: moments -> 12 pose partials
# ---------------------------------------------------------------------------

def render_tracking_depth_subtile(viewmat, K, width: int, height: int,
                                  slot3d, meta, near: float = 1e-2,
                                  far: float = 1e10):
    """Normalized depth + alpha from a prebuilt sub-tile slot buffer,
    cropped to (height, width): project8 -> subtile_fwd (K4a / K4b's plain
    forms; the depth target needs no gradient)."""
    n_ty = -(-height // TILE_H)
    n_tx = -(-width // TILE_W)
    cam = cam_vector(viewmat, K, width, height).detach().contiguous()
    out, _cd = subtile_fwd(project8(slot3d, cam, near, far), meta, n_ty,
                           n_tx)
    d_acc = unscramble_image(out[0], n_ty, n_tx)
    alpha = unscramble_image(out[1], n_ty, n_tx)
    d_acc = d_acc[:height, :width]
    alpha = alpha[:height, :width]
    depth = d_acc / alpha.clamp_min(1e-10)
    return depth, alpha
