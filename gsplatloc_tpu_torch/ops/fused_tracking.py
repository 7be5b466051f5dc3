"""Full-tile fused tracking rasterizer: in-kernel projection, pose-only
backward (the counterpart of the JAX package's ops/fused_tracking.py), and
the pose-path math every fused render shares.

The tracking hot loop optimizes ONLY the camera pose of a FROZEN,
ISOTROPIC Gaussian scene (identity quaternions, s*I scales — what
scene_from_point_cloud builds). The world covariance is then s^2*I, so one
variance row replaces the nine general covariance entries and the camera-
frame covariance M = R S R^T = s2*I folds into constants.

Slot record fields (8 fp32, buffer layout (8, M_pad)): 0 x, 1 y, 2 z
(world mean), 3 s2 (isotropic world variance), 4 opacity, 5..7 padding.
`build_slot_buffer` bins the scene into depth-sorted (16, 128) pixel tiles
at a rebuild pose and gathers these pose-independent records; between
rebuilds the kernels project every slot with the CURRENT pose.

Kernels (csrc/fused_tracking.cu), each with its plain PyTorch version here:
  fused_fwd    replaces the Pallas _fused_fwd_kernel    plain: _fused_fwd_plain
  fused_bwd    replaces the Pallas _fused_bwd_kernel    plain: _fused_bwd_plain
  fused_probe  replaces the Pallas _fused_probe_kernel  plain: _fused_probe_plain

The forward composites each tile's segment front to back in 128-slot
chunks with the gates of `_fused_alpha` in the reference (sigma >= 0,
alpha = min(opa*exp(-sigma), 0.999) >= 1/255, the projection's ok row, a
slot counts only while T*(1-alpha) > 1e-4), payload [qz, 1], and stops at
the first chunk boundary where no pixel of the tile is alive. The backward
replays exactly the forward's chunks and reduces to the 12 pose partials
[dR row-major, dt]; the probe marks the slots that reach a live pixel, and
`compact_slot_buffer` drops the others (exact at the probe pose).

Every CUDA kernel of the port inlines the shared math from
csrc/project.cuh (project_parts / project8_rows / pose_chain) in the SAME
operation order; the functions here are its plain PyTorch form and the
oracle the kernels are held against.
"""

from __future__ import annotations

import torch

from .. import kernels
from .._device import F32
from .binning import TILE_H, TILE_W, bin_and_sort
from .rasterize_tiles import (
    ALPHA_MAX,
    ALPHA_MIN,
    CHUNK,
    P,
    T_EPS,
    _from_tiles,
    _pixel_xy,
    _tile_bounds,
    _to_tiles,
)

NUM_ISO_ROWS = 8  # [x, y, z, s2, opa, pad, pad, pad]

EPS2D = 0.3
N_CAM = 18  # camera scalar vector: [fx, fy, cx, cy, R(9), t(3), W, H]
SIGMA_CUT = 80.0  # see _fused_chunk
BIG_BUDGET = 64  # splats binned over their full footprint (ops/binning.py)


def _project_slots(rec, cam):
    """Per-slot projection with the CURRENT pose on (1, C) rows of the
    (8, C) isotropic record block. Returns a dict of (1, C) rows."""
    return _project_parts(rec[0:1, :], rec[1:2, :], rec[2:3, :],
                          rec[3:4, :], rec[4:5, :], cam)


def _project_parts(x, y, z, s2, opa, cam):
    """Shape-generic body of `_project_slots`: x/y/z/s2/opa may be any
    broadcast-compatible tensors. cam: (N_CAM,) tensor
    [fx, fy, cx, cy, R00..R22 (row major), t, W, H]."""
    fx, fy, cx, cy = cam[0], cam[1], cam[2], cam[3]
    r = [cam[4 + i] for i in range(9)]
    t0, t1, t2 = cam[13], cam[14], cam[15]

    qx = r[0] * x + r[1] * y + r[2] * z + t0
    qy = r[3] * x + r[4] * y + r[5] * z + t1
    qz = r[6] * x + r[7] * y + r[8] * z + t2
    zs = torch.where(qz.abs() < 1e-8, 1e-8, qz)
    iz = 1.0 / zs
    u = fx * qx * iz + cx
    v = fy * qy * iz + cy

    # EWA jacobian with FoV clamp (matches ops/projection.py)
    lim_x = 1.3 * 0.5 * cam[16] / fx
    lim_y = 1.3 * 0.5 * cam[17] / fy
    txc = zs * torch.minimum(torch.maximum(qx * iz, -lim_x), lim_x)
    tyc = zs * torch.minimum(torch.maximum(qy * iz, -lim_y), lim_y)
    iz2 = iz * iz
    j00 = fx * iz
    j02 = -fx * txc * iz2
    j11 = fy * iz
    j12 = -fy * tyc * iz2

    # cov2d = J (s2*I) J^T + EPS2D*I
    a = s2 * (j00 * j00 + j02 * j02) + EPS2D
    b = s2 * (j02 * j12)
    c = s2 * (j11 * j11 + j12 * j12) + EPS2D
    det = a * c - b * b
    det_s = torch.where(det == 0.0, 1e-12, det)
    inv_det = 1.0 / det_s
    ca = c * inv_det
    cb = -b * inv_det
    cc = a * inv_det

    return dict(
        qx=qx, qy=qy, qz=qz, zs=zs, iz=iz, u=u, v=v,
        m00=s2, m01=0.0, m02=0.0, m11=s2, m12=0.0, m22=s2,
        j00=j00, j02=j02, j11=j11, j12=j12, txc=txc, tyc=tyc,
        a=a, b=b, c=c, inv_det=inv_det, ca=ca, cb=cb, cc=cc,
        det_ok=(det > 0.0),
        x=x, y=y, z=z, opa=opa,
        s=(s2, 0.0, 0.0, s2, 0.0, s2),
        r=r, fx=fx, fy=fy,
        lim_ok_x=((qx * iz).abs() < lim_x),
        lim_ok_y=((qy * iz).abs() < lim_y),
    )


def _project8_rows(pr, near, far):
    """THE canonical 8-row kernel-facing packing of the projection phase:
    [u, v, ca, cb, cc, qz, opa, ok] as an (8, C) stack."""
    ok_row = (
        pr["det_ok"] & (pr["qz"] > near) & (pr["qz"] < far)
    ).to(pr["u"].dtype)
    opa = pr["opa"].expand_as(pr["u"])
    return torch.cat(
        [pr["u"], pr["v"], pr["ca"], pr["cb"], pr["cc"], pr["qz"],
         opa, ok_row],
        dim=0,
    )


def _pose_chain(pr, m0, m_x, m_y, m_xx, m_xy, m_yy, d_z_direct,
                x0, y0, fx, fy, reduce=True):
    """Chain from the frame-local pixel moments of d_sigma (and the direct
    depth term) to the pose partial: dR (9, row major), dt (3). With
    reduce=True returns a (1, 16) row [dR, dt, 0, 0, 0, 0] summed over all
    slots; with reduce=False the 12 per-slot partial maps."""
    u_l = pr["u"] - x0
    v_l = pr["v"] - y0
    s1 = m_x - u_l * m0
    s2 = m_y - v_l * m0
    d_ca = 0.5 * (m_xx - 2.0 * u_l * m_x + u_l * u_l * m0)
    d_cb = m_xy - u_l * m_y - v_l * m_x + u_l * v_l * m0
    d_cc = 0.5 * (m_yy - 2.0 * v_l * m_y + v_l * v_l * m0)
    d_u = -(pr["ca"] * s1 + pr["cb"] * s2)
    d_v = -(pr["cc"] * s2 + pr["cb"] * s1)

    # conic -> cov2d(a, b, c): conic = [c, -b, a]/det, det = ac - b^2
    a_, b_, c_ = pr["a"], pr["b"], pr["c"]
    idet = pr["inv_det"]
    d_idet = d_ca * c_ + d_cb * (-b_) + d_cc * a_
    d_det = -d_idet * idet * idet
    d_a = d_cc * idet + d_det * c_
    d_b = -d_cb * idet - 2.0 * d_det * b_
    d_c = d_ca * idet + d_det * a_

    # cov2d(a,b,c) <- (j00, j02, j11, j12, M)
    j00, j02, j11, j12 = pr["j00"], pr["j02"], pr["j11"], pr["j12"]
    m00, m01, m02 = pr["m00"], pr["m01"], pr["m02"]
    m11, m12, m22 = pr["m11"], pr["m12"], pr["m22"]
    d_m00 = d_a * j00 * j00
    d_m01 = d_b * j00 * j11
    d_m02 = d_a * 2.0 * j00 * j02 + d_b * j00 * j12
    d_m11 = d_c * j11 * j11
    d_m12 = d_b * j02 * j11 + d_c * 2.0 * j11 * j12
    d_m22 = d_a * j02 * j02 + d_b * j02 * j12 + d_c * j12 * j12
    d_j00 = d_a * (2.0 * j00 * m00 + 2.0 * j02 * m02) + d_b * (j11 * m01 + j12 * m02)
    d_j02 = d_a * (2.0 * j00 * m02 + 2.0 * j02 * m22) + d_b * (j11 * m12 + j12 * m22)
    d_j11 = d_c * (2.0 * j11 * m11 + 2.0 * j12 * m12) + d_b * (j00 * m01 + j02 * m12)
    d_j12 = d_c * (2.0 * j11 * m12 + 2.0 * j12 * m22) + d_b * (j00 * m02 + j02 * m22)

    # u = fx qx iz + cx ; v = fy qy iz + cy
    iz = pr["iz"]
    iz2 = iz * iz
    qx, qy = pr["qx"], pr["qy"]
    d_qx = d_u * fx * iz
    d_qy = d_v * fy * iz
    d_qz = -(d_u * fx * qx + d_v * fy * qy) * iz2 + d_z_direct
    # j00 = fx iz ; j02 = -fx txc iz^2 ; txc = qz*clip(qx/qz): unclamped
    # txc = qx (d/dqx = 1, d/dqz = 0); clamped txc = +-lim*qz
    okx = pr["lim_ok_x"]
    oky = pr["lim_ok_y"]
    txc, tyc = pr["txc"], pr["tyc"]
    iz3 = iz2 * iz
    d_qz = d_qz - d_j00 * fx * iz2 - d_j11 * fy * iz2
    d_qz = d_qz + d_j02 * fx * (2.0 * txc * iz3) + d_j12 * fy * (2.0 * tyc * iz3)
    d_txc = -d_j02 * fx * iz2
    d_tyc = -d_j12 * fy * iz2
    zero = torch.zeros_like(d_txc)
    d_qx = d_qx + torch.where(okx, d_txc, zero)
    d_qz = d_qz + torch.where(okx, zero, d_txc * txc * iz)
    d_qy = d_qy + torch.where(oky, d_tyc, zero)
    d_qz = d_qz + torch.where(oky, zero, d_tyc * tyc * iz)

    # M = R S R^T: dR = (G + G^T) R S
    g00, g01, g02 = d_m00, d_m01, d_m02
    g11, g12, g22 = d_m11, d_m12, d_m22
    r_ = pr["r"]
    s00, s01, s02, s11, s12, s22 = pr["s"]
    rs = [
        (r_[0] * s00 + r_[1] * s01 + r_[2] * s02,
         r_[0] * s01 + r_[1] * s11 + r_[2] * s12,
         r_[0] * s02 + r_[1] * s12 + r_[2] * s22),
        (r_[3] * s00 + r_[4] * s01 + r_[5] * s02,
         r_[3] * s01 + r_[4] * s11 + r_[5] * s12,
         r_[3] * s02 + r_[4] * s12 + r_[5] * s22),
        (r_[6] * s00 + r_[7] * s01 + r_[8] * s02,
         r_[6] * s01 + r_[7] * s11 + r_[8] * s12,
         r_[6] * s02 + r_[7] * s12 + r_[8] * s22),
    ]
    g_mat = [
        [2.0 * g00, g01, g02],
        [g01, 2.0 * g11, g12],
        [g02, g12, 2.0 * g22],
    ]
    d_r = [[None] * 3 for _ in range(3)]
    for i_ in range(3):
        for k_ in range(3):
            acc_ = 0.0
            for j_ in range(3):
                acc_ = acc_ + g_mat[i_][j_] * rs[j_][k_]
            d_r[i_][k_] = acc_

    # q = R p + t: dR_ik += d_q_i * p_k ; dt_i += d_q_i
    pw = [pr["x"], pr["y"], pr["z"]]
    d_q = [d_qx, d_qy, d_qz]
    for i_ in range(3):
        for k_ in range(3):
            d_r[i_][k_] = d_r[i_][k_] + d_q[i_] * pw[k_]

    maps = [d_r[i_][k_] for i_ in range(3) for k_ in range(3)] + d_q
    if not reduce:
        return maps
    parts = [torch.sum(m) for m in maps]
    zero_s = torch.zeros((), dtype=parts[0].dtype, device=parts[0].device)
    return torch.stack(parts + [zero_s] * 4).reshape(1, 16)


def cam_vector(viewmat, K, width, height):
    """Pack the camera into the (18,) scalar vector the kernels consume.
    Differentiable w.r.t. viewmat (autograd chains d_cam back through it).
    The [width, height] pair is filled on the device, so that no host copy
    (and no wait for the card) sits in a tracking step."""
    wh = torch.full((2,), float(width), dtype=F32, device=viewmat.device)
    wh[1:].fill_(float(height))
    return torch.cat([
        torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]),
        viewmat[:3, :3].reshape(-1),
        viewmat[:3, 3],
        wh,
    ]).to(F32)


# ---------------------------------------------------------------------------
# Slot buffer
# ---------------------------------------------------------------------------

def build_slot_buffer(scene, viewmat, K, width: int, height: int,
                      near: float, far: float):
    """Project with the given pose, bin/sort into (16, 128) tiles and gather
    the POSE-INDEPENDENT 3D slot buffer (8, M_pad) + meta (n_tiles+2,)
    int32 = [0, *tile_starts]. Rebuilt when the tracking loop's motion gate
    fires. The BIG_BUDGET biggest splats are binned over their full
    footprint (ops/binning.py). Padding slots hold Gaussian 0's record, as the
    reference's zero-padded pair list does; no walk reaches them. Assumes
    the isotropic-scene contract (module docstring)."""
    from .projection import project_gaussians

    proj = project_gaussians(
        scene.means, scene.quats, scene.scales, viewmat, K, width, height,
        near, far,
    )
    binning = bin_and_sort(
        proj.mean2d, proj.radius, proj.depth, proj.valid, width, height,
        tile_h=TILE_H, tile_w=TILE_W, chunk=CHUNK, needs_inv_perm=False,
        big_budget=BIG_BUDGET,
    )
    zero = torch.zeros_like(proj.depth)
    records = torch.stack(
        [scene.means[:, 0], scene.means[:, 1], scene.means[:, 2],
         scene.scales[:, 0] * scene.scales[:, 0], scene.opacities]
        + [zero] * (NUM_ISO_ROWS - 5),
        dim=1,
    )  # (N, 8)
    slot3d = records[binning.pair_gauss.long()].T.contiguous()
    meta = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=slot3d.device),
        binning.tile_starts,
    ])
    return slot3d.detach(), meta, binning


def _fused_chunk(slot3d, cam, col0, starts, ends, px, py, near, far):
    """One 128-slot chunk of each of n tiles (first columns col0 (n,),
    segments [starts, ends), pixel centres px/py (n, P)), projected with
    the current camera: the gated alpha (n, C, P) of the reference's
    `_fused_alpha`, dx, dy (n, C, P), the in-segment mask (n, C), the
    projection dict of (1, n, C) rows and its 8-row packing (8, n, C).
    Columns at or past M_pad read as 0."""
    m_pad = slot3d.shape[1]
    idx = col0[:, None] + torch.arange(CHUNK, device=col0.device)  # (n, C)
    rec = slot3d[:, idx.clamp_max(m_pad - 1)]
    rec = torch.where((idx < m_pad)[None], rec, 0.0)  # (8, n, C)
    pr = _project_slots(rec, cam)
    p8 = _project8_rows(pr, near, far)  # (8, n, C)
    u, v, ca, cb, cc, _qz, opa, ok = (p8[k][:, :, None] for k in range(8))
    dx = px[:, None, :] - u
    dy = py[:, None, :] - v
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    # exp(-sigma) for sigma > SIGMA_CUT only meets the alpha >= 1/255 gate
    # at opacities above 1e37, so the cut changes no gated alpha; it keeps
    # the CPU's exp off its slow underflow path (most pairs of a tile lie
    # far outside the splat's footprint). The kernel evaluates expf as is.
    alpha = torch.clamp_max(
        opa * torch.exp(-torch.clamp_max(sigma, SIGMA_CUT)), ALPHA_MAX)
    in_seg = (idx >= starts[:, None]) & (idx < ends[:, None])
    gate = (in_seg[:, :, None] & (ok > 0.0) & (sigma >= 0.0)
            & (alpha >= ALPHA_MIN))
    return torch.where(gate, alpha, 0.0), dx, dy, in_seg, pr, p8


def _walk_setup(slot3d, meta, n_ty, n_tx):
    n_tiles = n_ty * n_tx
    starts, ends, base, n_chunks = _tile_bounds(meta, n_tiles)
    px, py = _pixel_xy(n_ty, n_tx, meta[0].long(), slot3d.device)
    return n_tiles, starts, ends, base, n_chunks, px.to(slot3d.dtype), \
        py.to(slot3d.dtype)


def _live_tiles(t, c, n_chunks):
    """Tiles whose walk enters chunk c: some pixel alive, chunks left."""
    return torch.nonzero((t.max(dim=1).values > T_EPS) & (c < n_chunks))[:, 0]


# ---------------------------------------------------------------------------
# K7a: forward walk with in-kernel projection
# ---------------------------------------------------------------------------

def _fused_fwd_plain(slot3d, meta, cam, n_ty, n_tx, near, far, stats=None):
    """Plain PyTorch forward walk: chunk by chunk, the tiles still alive at
    the chunk's entry project the chunk and advance one slot per iteration
    together (vectorized over those tiles and their 2048 pixels, sequential
    along depth order — the kernel's recurrence and operation order).
    Returns (out (2, hp, wp) [depth_acc, alpha], chunks_done (n_tiles,)
    int32 counted from floor(start/128)*128). stats (optional dict)
    receives `pairs` (in-segment (slot, pixel) pairs met while the pixel
    was alive) and `hits` (those that passed the alpha gates). Generic in
    the dtype of slot3d and cam."""
    n_tiles, starts, ends, base, n_chunks, px, py = _walk_setup(
        slot3d, meta, n_ty, n_tx)
    dev, dt = slot3d.device, slot3d.dtype
    t = torch.ones((n_tiles, P), dtype=dt, device=dev)
    acc = torch.zeros((2, n_tiles, P), dtype=dt, device=dev)
    cd = torch.zeros((n_tiles,), dtype=torch.int32, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    for c in range(int(n_chunks.max()) if n_tiles else 0):
        act = _live_tiles(t, c, n_chunks)
        if act.numel() == 0:
            break
        cd[act] += 1
        alpha, _dx, _dy, in_seg, _pr, p8 = _fused_chunk(
            slot3d, cam, base[act] + c * CHUNK, starts[act], ends[act],
            px[act], py[act], near, far)
        ta, aa = t[act], acc[:, act]
        # payload [qz, 1] (2, n, C, 1); 1 * w == w exactly
        chan = torch.stack([p8[5], torch.ones_like(p8[5])])[..., None]
        one_minus = 1.0 - alpha
        for jj in range(CHUNK):
            a = alpha[:, jj]
            if stats is not None:
                alive = (ta > T_EPS) & in_seg[:, jj:jj + 1]
                pairs += alive.sum()
                hits += (alive & (a > 0.0)).sum()
            t_incl = ta * one_minus[:, jj]
            w = torch.where(t_incl > T_EPS, ta * a, 0.0)
            aa = aa + chan[:, :, jj] * w
            ta = t_incl
        t[act], acc[:, act] = ta, aa
    if stats is not None:
        stats["pairs"], stats["hits"] = int(pairs), int(hits)
    return _from_tiles(acc, n_ty, n_tx), cd


def fused_fwd(slot3d, meta, cam, n_ty, n_tx, near, far):
    """Depth + alpha of the slot buffer at the camera `cam` (18,). Returns
    (out (2, n_ty*16, n_tx*128) [depth_acc, alpha], chunks_done (n_tiles,)
    int32). CUDA tensor: the hand-written kernel (csrc/fused_tracking.cu
    fused_walk_kernel<false>, which replaces the Pallas _fused_fwd_kernel;
    bound by bytes — one block per 16x128 tile, 256 threads of 8 pixels;
    each warp walks the segment on its own, projecting 32 slots at a time,
    only the slots whose footprint box meets its 32x8 pixels, and stops at
    the first 128-slot chunk boundary with none of them alive; chunks_done
    is the largest of the warps' stops). CPU tensor: the plain version
    `_fused_fwd_plain`."""
    if not slot3d.is_cuda:
        return _fused_fwd_plain(slot3d, meta, cam, n_ty, n_tx, near, far)
    n_tiles = n_ty * n_tx
    mp = slot3d.shape[1]
    dev = slot3d.device
    kernels.require(slot3d, "slot3d", (NUM_ISO_ROWS, mp))
    kernels.require(meta, "meta", (n_tiles + 2,), dtype=torch.int32,
                    device=dev)
    kernels.require_cam(cam, dev)
    out = torch.empty((2, n_ty * TILE_H, n_tx * TILE_W), dtype=F32,
                      device=dev)
    cd = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    lib = kernels.load()
    err = lib.gsl_fused_fwd(meta.data_ptr(), cam.data_ptr(),
                            slot3d.data_ptr(), out.data_ptr(), cd.data_ptr(),
                            n_ty, n_tx, mp, float(near), float(far),
                            kernels.stream_ptr())
    kernels.check(err, "fused_fwd")
    fused_fwd.launches += 1
    return out, cd


fused_fwd.launches = 0


# ---------------------------------------------------------------------------
# K7b: replay + compositing adjoint -> 12 pose partials
# ---------------------------------------------------------------------------

def _fused_bwd_plain(slot3d, meta, cam, chunks_done, px_in, n_ty, n_tx,
                     near, far, stats=None):
    """Plain PyTorch backward walk over exactly the forward's chunks, with
    the compositing adjoint of the reference's _fused_bwd_kernel, per
    pixel:

      phi = g_d*qz + g_a;  run = running sum of w*phi;
      suffix = g_tot - run  with g_tot = g_d*depth_acc + g_a*alpha;
      d_alpha = T_prev*phi - suffix / max(1 - alpha, 1 - ALPHA_MAX), gated
                by live & alpha > 0, and 0 at alpha >= ALPHA_MAX;
      d_sigma = -alpha*d_alpha.

    Per slot, summed over its tile's 2048 pixels in the DIRECT form:
    sum d_sigma*dx, d_sigma*dy, d_sigma*dx^2, d_sigma*dx*dy, d_sigma*dy^2
    and w*g_d (dx = px - u, dy = py - v). The pose chain then runs per slot
    with the slot's own (u, v) as the moment origin (u_l = v_l = 0
    exactly), for every walked in-segment slot with a nonzero sum, and the
    sum over slots comes last. (The reference expands the sums into
    tile-local pixel moments, which loses digits to cancellation.)
    px_in: (4, hp, wp) = [depth_acc, alpha, g_d, g_a]. Returns (12,) pose
    partials [dR row-major, dt]. stats (optional dict) receives `chained`,
    the number of slots that went through the pose chain. Generic in the
    dtype of slot3d and cam."""
    n_tiles, starts, ends, base, _, px, py = _walk_setup(
        slot3d, meta, n_ty, n_tx)
    dev, dt = slot3d.device, slot3d.dtype
    rows = _to_tiles(px_in.to(dt), n_ty, n_tx)  # (4, n_tiles, P)
    g_d, g_a = rows[2], rows[3]
    g_tot = g_d * rows[0] + g_a * rows[1]
    t = torch.ones((n_tiles, P), dtype=dt, device=dev)
    run = torch.zeros_like(t)
    parts = [torch.zeros((12, 0), dtype=dt, device=dev)]
    cd = chunks_done.long()
    for c in range(int(cd.max()) if n_tiles else 0):
        act = torch.nonzero(c < cd)[:, 0]
        alpha, dx, dy, in_seg, pr, p8 = _fused_chunk(
            slot3d, cam, base[act] + c * CHUNK, starts[act], ends[act],
            px[act], py[act], near, far)
        ta, ra, gt = t[act], run[act], g_tot[act]
        gd, ga = g_d[act][:, None, :], g_a[act][:, None, :]
        # what does not depend on the transmittance, for the whole chunk
        # at once (elementwise, so the same values as slot by slot)
        one_minus = 1.0 - alpha
        phi = gd * p8[5][..., None] + ga  # (n, C, P)
        inv_om = 1.0 / torch.clamp_min(one_minus, 1.0 - ALPHA_MAX)
        t_prev = torch.empty_like(alpha)
        suffix = torch.empty_like(alpha)
        wb = torch.empty_like(alpha)
        live = torch.empty(alpha.shape, dtype=torch.bool, device=dev)
        for jj in range(CHUNK):
            t_prev[:, jj] = ta
            t_incl = ta * one_minus[:, jj]
            live[:, jj] = lv = t_incl > T_EPS
            wb[:, jj] = w = torch.where(lv, ta * alpha[:, jj], 0.0)
            ra = ra + w * phi[:, jj]
            suffix[:, jj] = gt - ra
            ta = t_incl
        t[act], run[act] = ta, ra
        d_alpha = t_prev * phi - suffix * inv_om
        d_alpha = torch.where(live & (alpha > 0.0), d_alpha, 0.0)
        d_alpha = torch.where(alpha >= ALPHA_MAX, 0.0, d_alpha)
        ds = d_alpha * (-alpha)
        sums = [(ds * dx).sum(-1), (ds * dy).sum(-1), (ds * dx * dx).sum(-1),
                (ds * dx * dy).sum(-1), (ds * dy * dy).sum(-1),
                (wb * gd).sum(-1)]  # each (n, C)
        chained = in_seg & torch.stack(sums).ne(0.0).any(dim=0)
        maps = _pose_chain(pr, torch.zeros_like(sums[0]), *sums,
                           pr["u"], pr["v"], cam[0], cam[1], reduce=False)
        maps = torch.stack([m.reshape(chained.shape) for m in maps])
        parts.append(maps[:, chained])  # (12, slots of this chunk)
    parts = torch.cat(parts, dim=1)
    if stats is not None:
        stats["chained"] = parts.shape[1]
    return parts.sum(dim=1)


def fused_bwd(slot3d, meta, cam, chunks_done, px_in, n_ty, n_tx, near,
              far):
    """(12,) pose partials [dR row-major, dt] of the forward walk's outputs
    (see `_fused_bwd_plain`). CUDA tensor: the hand-written kernel
    (csrc/fused_tracking.cu fused_bwd_kernel, which replaces the Pallas
    _fused_bwd_kernel; bound by operations — the forward's block shape,
    each warp walking the segment on its own and each slot only over the
    pixels of its footprint box (rasterize_tiles._footprint_box of its
    projected rows), 6 per-slot sums reduced per thread, per warp by
    shuffles, then over the warps that met the slot in a fixed order into
    a (6, M_pad) scratch, the pose chain per slot, the tile's partials in
    slot order and the (n_tiles, 12) scratch summed in a fixed order in
    double, without atomics). CPU tensor: the plain version
    `_fused_bwd_plain`, which walks every pixel."""
    if not slot3d.is_cuda:
        return _fused_bwd_plain(slot3d, meta, cam, chunks_done, px_in, n_ty,
                                n_tx, near, far)
    n_tiles = n_ty * n_tx
    mp = slot3d.shape[1]
    dev = slot3d.device
    kernels.require(slot3d, "slot3d", (NUM_ISO_ROWS, mp))
    kernels.require(meta, "meta", (n_tiles + 2,), dtype=torch.int32,
                    device=dev)
    kernels.require_cam(cam, dev)
    kernels.require(chunks_done, "chunks_done", (n_tiles,),
                    dtype=torch.int32, device=dev)
    kernels.require(px_in, "px_in", (4, n_ty * TILE_H, n_tx * TILE_W),
                    device=dev)
    sums = torch.empty((6, mp), dtype=F32, device=dev)  # per walked slot
    scratch = torch.empty((n_tiles, 12), dtype=F32, device=dev)
    out = torch.empty((12,), dtype=F32, device=dev)
    lib = kernels.load()
    err = lib.gsl_fused_bwd(meta.data_ptr(), cam.data_ptr(),
                            slot3d.data_ptr(), chunks_done.data_ptr(),
                            px_in.data_ptr(), sums.data_ptr(),
                            scratch.data_ptr(), out.data_ptr(), n_ty, n_tx,
                            mp, float(near),
                            float(far), kernels.stream_ptr())
    kernels.check(err, "fused_bwd")
    fused_bwd.launches += 1
    return out


fused_bwd.launches = 0


# ---------------------------------------------------------------------------
# K7c: per-slot contribution probe, and the compaction it drives
# ---------------------------------------------------------------------------

def _fused_probe_plain(slot3d, meta, cam, n_ty, n_tx, near, far):
    """Plain PyTorch probe: the forward's walk, marking contrib[col] = 1 iff
    the slot has alpha > 0 with T_prefix > T_EPS at some pixel of its tile.
    Returns (contrib (M_pad,), chunks_done (n_tiles,) int32 as the forward
    counts them); every column outside the walked in-segment coverage is
    0."""
    n_tiles, starts, ends, base, n_chunks, px, py = _walk_setup(
        slot3d, meta, n_ty, n_tx)
    dev, dt = slot3d.device, slot3d.dtype
    t = torch.ones((n_tiles, P), dtype=dt, device=dev)
    contrib = torch.zeros((slot3d.shape[1],), dtype=dt, device=dev)
    cd = torch.zeros((n_tiles,), dtype=torch.int32, device=dev)
    for c in range(int(n_chunks.max()) if n_tiles else 0):
        act = _live_tiles(t, c, n_chunks)
        if act.numel() == 0:
            break
        cd[act] += 1
        col0 = base[act] + c * CHUNK
        alpha, _dx, _dy, in_seg, _pr, _p8 = _fused_chunk(
            slot3d, cam, col0, starts[act], ends[act], px[act], py[act],
            near, far)
        ta = t[act]
        one_minus = 1.0 - alpha
        reach = torch.empty(in_seg.shape, dtype=torch.bool, device=dev)
        for jj in range(CHUNK):
            reach[:, jj] = ((alpha[:, jj] > 0.0) & (ta > T_EPS)).any(dim=1)
            ta = ta * one_minus[:, jj]
        t[act] = ta
        idx = col0[:, None] + torch.arange(CHUNK, device=dev)
        contrib[idx[in_seg]] = reach[in_seg].to(dt)
    return contrib, cd


def fused_probe(slot3d, meta, cam, n_ty, n_tx, near, far):
    """Run the contribution probe at the camera `cam`. Returns (contrib
    (M_pad,) f32, chunks_done (n_tiles,) int32); columns outside each
    tile's walked coverage are 0. CUDA tensor: the hand-written kernel
    (csrc/fused_tracking.cu fused_walk_kernel<true>, which replaces the
    Pallas _fused_probe_kernel; bound by bytes — fused_fwd's walk without
    its accumulators: each warp walks the segment on its own, projecting
    32 slots at a time, only the slots whose footprint box meets its 32x8
    pixels, stopping at the first 128-slot chunk boundary with none of them
    alive; per 32 slots the warp ORs its lanes' masks of the slots that
    reached a pixel, and the lane that staged a reached slot writes 1.0 at
    its column of the zero-filled buffer; chunks_done is the largest of
    the warps' stops). CPU tensor: the plain version `_fused_probe_plain`."""
    if not slot3d.is_cuda:
        return _fused_probe_plain(slot3d, meta, cam, n_ty, n_tx, near, far)
    n_tiles = n_ty * n_tx
    m_pad = slot3d.shape[1]
    dev = slot3d.device
    kernels.require(slot3d, "slot3d", (NUM_ISO_ROWS, m_pad))
    kernels.require(meta, "meta", (n_tiles + 2,), dtype=torch.int32,
                    device=dev)
    kernels.require_cam(cam, dev)
    contrib = torch.zeros((m_pad,), dtype=F32, device=dev)
    cd = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    lib = kernels.load()
    err = lib.gsl_fused_probe(meta.data_ptr(), cam.data_ptr(),
                              slot3d.data_ptr(), contrib.data_ptr(),
                              cd.data_ptr(), n_ty, n_tx, m_pad, float(near),
                              float(far), kernels.stream_ptr())
    kernels.check(err, "fused_probe")
    fused_probe.launches += 1
    return contrib, cd


fused_probe.launches = 0


def compact_slot_buffer(slot3d, meta, contrib, chunks_done):
    """Pack the contributing slot columns to the front of each tile's
    segment. The buffer keeps its padded size; only the tile offsets
    shrink, so the walks cover far fewer chunks. A column stays iff it lies
    in a tile's segment, inside the chunks the probe walked, and contrib
    marks it. Kept columns keep their tile-major depth order (a stable
    partition), dropped ones follow; the new offsets are an exclusive
    cumsum of the keep mask. Exact at the probe pose: a dropped slot has
    alpha 0 or a dead transmittance at every pixel of its tile."""
    m_pad = slot3d.shape[1]
    dev = slot3d.device
    starts = meta[1:].long()
    n_tiles = starts.shape[0] - 1
    base_t = (starts[:-1] // CHUNK) * CHUNK
    cov_end = base_t + chunks_done.long() * CHUNK
    cols = torch.arange(m_pad, device=dev)
    tile_of_col = (torch.searchsorted(starts, cols, right=True) - 1).clamp(
        0, n_tiles - 1)
    live = ((cols >= starts[0]) & (cols < starts[n_tiles])
            & (cols < cov_end[tile_of_col]) & (contrib > 0.0))
    perm = torch.argsort((~live).to(torch.uint8), stable=True)
    compacted = slot3d[:, perm].contiguous()
    ks = torch.cumsum(live.to(torch.int32), 0)
    ks_excl = torch.cat([torch.zeros((1,), dtype=ks.dtype, device=dev), ks])
    new_starts = ks_excl[starts].to(torch.int32)
    return compacted, torch.cat([meta[0:1], new_starts])


# ---------------------------------------------------------------------------
# The differentiable render
# ---------------------------------------------------------------------------

class _FusedRender(torch.autograd.Function):
    """Depth + alpha render of a slot buffer, differentiable w.r.t. the cam
    vector only: forward fused_fwd, backward fused_bwd (which replays the
    forward's chunks). d_cam is zero for fx, fy, cx, cy, W and H; R gets
    d[:9] and t gets d[9:12]."""

    @staticmethod
    def forward(ctx, slot3d, meta, cam, n_ty, n_tx, near, far):
        cam = cam.detach().contiguous()
        out, cd = fused_fwd(slot3d, meta, cam, n_ty, n_tx, near, far)
        ctx.save_for_backward(slot3d, meta, cam, out, cd)
        ctx.args = (n_ty, n_tx, near, far)
        return out[0], out[1]

    @staticmethod
    def backward(ctx, g_dacc, g_alpha):
        slot3d, meta, cam, out, cd = ctx.saved_tensors
        n_ty, n_tx, near, far = ctx.args
        gcot = [torch.zeros_like(out[0]) if g is None else g.to(out.dtype)
                for g in (g_dacc, g_alpha)]
        px_in = torch.cat([out, torch.stack(gcot)]).contiguous()
        d = fused_bwd(slot3d, meta, cam, cd, px_in, n_ty, n_tx, near, far)
        d_cam = torch.cat([d.new_zeros(4), d[:12], d.new_zeros(2)])
        return None, None, d_cam, None, None, None, None


def fused_render(slot3d, meta, cam, n_ty, n_tx, near, far):
    """Depth+alpha render of a slot-ordered frozen scene, differentiable
    w.r.t. the cam vector ONLY. Returns (depth_acc (hp, wp), alpha
    (hp, wp))."""
    return _FusedRender.apply(slot3d, meta, cam, n_ty, n_tx, near, far)


def render_tracking_depth(viewmat, K, width: int, height: int,
                          slot3d, meta, near: float = 1e-2,
                          far: float = 1e10, mesh=None):
    """Expected-depth render from a prebuilt slot buffer; differentiable
    w.r.t. viewmat. Returns (depth (H, W), alpha (H, W)). With a TileMesh
    (parallel/sharded.py) the tile rows render in bands over its devices
    (n_ty padded to the band count) and the pose partials are summed in
    band order."""
    n_ty = -(-height // TILE_H)
    n_tx = -(-width // TILE_W)
    cam = cam_vector(viewmat, K, width, height)
    if mesh is None:
        d_acc, alpha = fused_render(slot3d, meta, cam, n_ty, n_tx, near, far)
    else:
        from ..parallel.sharded import (
            _check_mesh, _pad_starts, sharded_fused_render,
        )

        d = _check_mesh(mesh)
        n_ty_pad = -(-n_ty // d) * d
        starts = _pad_starts(meta[1:], (n_ty_pad - n_ty) * n_tx)
        d_acc, alpha = sharded_fused_render(slot3d, starts, cam, n_ty_pad,
                                            n_tx, mesh, near, far)
    d_acc = d_acc[:height, :width]
    alpha = alpha[:height, :width]
    depth = d_acc / alpha.clamp_min(1e-10)
    return depth, alpha
