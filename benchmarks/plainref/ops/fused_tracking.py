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

from .._device import F32

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
    Differentiable w.r.t. viewmat (autograd chains d_cam back through it)."""
    return torch.cat([
        torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]),
        viewmat[:3, :3].reshape(-1),
        viewmat[:3, 3],
        torch.tensor([float(width), float(height)], dtype=F32,
                     device=viewmat.device),
    ]).to(F32)


# ---------------------------------------------------------------------------
# Slot buffer
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# K7a: forward walk with in-kernel projection
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# K7b: replay + compositing adjoint -> 12 pose partials
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# K7c: per-slot contribution probe, and the compaction it drives
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# The differentiable render
# ---------------------------------------------------------------------------

