"""Sub-tile tracking rasterizer: (16, 16) pixel sub-tiles, forward only.

Same math and gating as the K-cover render, evaluated by WALKING each
sub-tile's depth-sorted slot segment: project every slot once
(`project8`), then composite front to back per pixel with a transmittance
early stop (`subtile_fwd`). On the main path it renders the depth target
of a frame pair (data/parser.py render_depth_gt), forward and without
gradient; the backward of this walk is not ported yet and asking for it
raises.

Sub-tile layout: the image is padded to (16, 128) macro tiles; each macro
tile holds N_SUB = 8 sub-tiles of 16x16 pixels. Sub-tile segments are
numbered global-row-major over the image, per-sub-tile pixels are
flattened r*SUB_W + c, and a flat "scrambled" image holds sub-tile `st` at
[st*P_SUB, (st+1)*P_SUB); (H, W) is recovered by unscramble_image.

Kernels (csrc/subtile_fwd.cu), each with its plain PyTorch version here:
  project8    replaces the Pallas _project8_kernel     plain: _project8
  subtile_fwd replaces the Pallas _subtile_fwd_kernel  plain: _subtile_fwd_plain
"""

from __future__ import annotations

import torch

from .. import kernels
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

# fp-noise slack for the (analytically >= 0) expanded sigma polynomial:
# the expansion recombines terms up to ~1e3 in magnitude, so sigma == 0 at
# a splat centre can come back a few 1e-4 negative.
SIG_EPS = 1e-2


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


def _subtile_fwd_plain(proj8, meta, n_ty, n_tx, stats=None):
    """Plain PyTorch sub-tile walk: every segment advances one slot per
    iteration (vectorized over segments and pixels, sequential along depth
    order — the same per-pixel recurrence and the same operation order as
    the kernel). Returns (out (2, M_out) [depth_acc; alpha], chunks_done
    (n_seg,) int32). Reads the longest segment length back to the host.
    stats (optional dict) receives `pairs`: the (live slot, pixel) pairs
    the walked chunks hold — the work this input needs."""
    dev = proj8.device
    n_seg = n_ty * n_tx * N_SUB
    m_pad = proj8.shape[1]
    starts, ends = _segment_bounds(meta, n_seg)
    seg_len = ends - starts
    max_len = int(seg_len.max())
    x0, y0 = _segment_origins(meta, n_seg, n_tx)
    mono = _sub_mono(dev)
    t = torch.ones((n_seg, P_SUB), dtype=F32, device=dev)
    dacc = torch.zeros_like(t)
    aacc = torch.zeros_like(t)
    cd = torch.zeros((n_seg,), dtype=torch.int32, device=dev)
    alive = torch.zeros((n_seg,), dtype=torch.bool, device=dev)
    live_slots = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(max_len):
        if j % CHUNK == 0:
            # chunk-granular early stop, as the kernel: a chunk is walked
            # iff some pixel of the sub-tile is still alive at its entry
            alive = (t.max(dim=1).values > T_EPS) & (j < seg_len)
            if not bool(alive.any()):
                break
            cd += alive.to(torch.int32)
        inseg = (j < seg_len)[:, None]
        idx = (starts + j).clamp_max(m_pad - 1)
        mat = _coeff_mat(proj8[:, idx], x0[None, :], y0[None, :])
        if stats is not None:
            live_slots += (alive & (mat[:, 7] != 0.0)).sum()
        alpha = torch.where(inseg, _sub_alpha(mat, mono), 0.0)
        t_incl = t * (1.0 - alpha)
        w = torch.where(t_incl > T_EPS, t * alpha, 0.0)
        dacc = dacc + mat[:, 6:7] * w
        aacc = aacc + w
        t = t_incl
    if stats is not None:
        stats["pairs"] = int(live_slots) * P_SUB
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


class _SubtileRender(torch.autograd.Function):
    """Forward-only sub-tile render: the backward of the walk is a later
    slice of the port."""

    @staticmethod
    def forward(ctx, slot3d, meta, cam, n_ty, n_tx, near, far):
        proj8 = project8(slot3d, cam.detach().contiguous(), near, far)
        out, _cd = subtile_fwd(proj8, meta, n_ty, n_tx)
        return (unscramble_image(out[0], n_ty, n_tx),
                unscramble_image(out[1], n_ty, n_tx))

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the sub-tile render is forward-only in this slice of the port: "
            "its backward (the kcover=0 tracking path) is not ported yet"
        )


def subtile_render(slot3d, meta, cam, n_ty, n_tx, m_pad, near, far):
    """Depth+alpha render from a sub-tile slot buffer. Returns
    (depth_acc (hp, wp), alpha (hp, wp)). Forward only: calling backward
    through it raises NotImplementedError."""
    return _SubtileRender.apply(slot3d, meta, cam, n_ty, n_tx, near, far)


def render_tracking_depth_subtile(viewmat, K, width: int, height: int,
                                  slot3d, meta, near: float = 1e-2,
                                  far: float = 1e10):
    """Normalized depth + alpha from a prebuilt sub-tile slot buffer,
    cropped to (height, width). Forward only."""
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
