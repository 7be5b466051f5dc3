"""Dense hybrid RGB-D odometry (multi-scale photometric + geometric GN).

The counterpart of the reference's Open3D HYBRID path
(o3d.t.pipelines.odometry.rgbd_odometry_multi_scale with Method.Hybrid;
Park et al. 2017 "Colored Point Cloud Registration Revisited" energy):
estimates T_target_source between two RGB-D frames by Gauss-Newton on
per-pixel photometric (intensity) + geometric (depth) residuals over an
image pyramid. A dense image-space method: all (H, W) tensor math on one
device, a fixed number of Gauss-Newton steps per pyramid level with no
host read inside a level. Plain PyTorch, float32 (TF32 off), the normal
equations as `torch.matmul`.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_f32, resolve_device
from ..ops.lie import se3_exp


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling (H and W must be even; crop if not)."""
    h, w = img.shape[:2]
    img = img[: h - h % 2, : w - w % 2]
    return 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                   + img[0::2, 1::2] + img[1::2, 1::2])


def _downsample_depth(depth: torch.Tensor) -> torch.Tensor:
    """2x2 pooling of depth, averaging only valid (>0) pixels."""
    h, w = depth.shape
    depth = depth[: h - h % 2, : w - w % 2]
    stack = torch.stack([depth[0::2, 0::2], depth[1::2, 0::2],
                         depth[0::2, 1::2], depth[1::2, 1::2]])
    valid = (stack > 0).to(depth.dtype)
    s = torch.sum(stack * valid, dim=0)
    c = torch.sum(valid, dim=0)
    return torch.where(c > 0, s / torch.clamp(c, min=1), 0.0)


def _gradients(img: torch.Tensor):
    """Central-difference gradients (gx, gy) with zero borders."""
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return gx, gy


def _masked_gradients(img: torch.Tensor, valid: torch.Tensor):
    """Central-difference gradients zeroed where either neighbour is
    invalid (a depth hole next to a 3 m surface otherwise reads as a
    ~1.5 m/px gradient and pulls the GN normal equations at every depth
    edge)."""
    gx, gy = _gradients(img)
    vx = torch.zeros_like(valid)
    vy = torch.zeros_like(valid)
    vx[:, 1:-1] = valid[:, 2:] & valid[:, :-2]
    vy[1:-1, :] = valid[2:, :] & valid[:-2, :]
    return torch.where(vx, gx, 0.0), torch.where(vy, gy, 0.0)


def _bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear sample img at (u, v); returns (values, in_bounds_mask)."""
    h, w = img.shape
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    u0i = u0.to(torch.int32)
    v0i = v0.to(torch.int32)
    inb = (u0i >= 0) & (u0i < w - 1) & (v0i >= 0) & (v0i < h - 1)
    u0c = torch.clamp(u0i, 0, w - 2).long()
    v0c = torch.clamp(v0i, 0, h - 2).long()
    i00 = img[v0c, u0c]
    i01 = img[v0c, u0c + 1]
    i10 = img[v0c + 1, u0c]
    i11 = img[v0c + 1, u0c + 1]
    val = (i00 * (1 - fu) * (1 - fv) + i01 * fu * (1 - fv)
           + i10 * (1 - fu) * fv + i11 * fu * fv)
    return val, inb


def _bilinear_valid(img: torch.Tensor, valid: torch.Tensor,
                    u: torch.Tensor, v: torch.Tensor):
    """Bilinear sample gated on ALL FOUR corners being valid: blending an
    invalid (0) depth corner into the sample biases it low, so such samples
    are rejected outright, as Open3D's hybrid odometry does. Returns
    (values, in_bounds_and_all_corners_valid)."""
    val, inb = _bilinear(img, u, v)
    cmin, _ = _bilinear(valid.to(img.dtype), u, v)
    return val, inb & (cmin >= 1.0 - 1e-6)


def _gn_level(intensity_s, depth_s, intensity_t, depth_t, K, T0,
              iterations: int, sigma: float, max_depth: float,
              depth_diff_max: float):
    """`iterations` Gauss-Newton steps of one pyramid level from T0."""
    h, w = depth_s.shape
    dev = depth_s.device
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    vs, us = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    valid_s = (depth_s > 0) & (depth_s < max_depth)
    xs = (us - cx) / fx * depth_s
    ys = (vs - cy) / fy * depth_s

    valid_t = (depth_t > 0) & (depth_t < max_depth)
    gtx, gty = _gradients(intensity_t)
    gdx, gdy = _masked_gradients(depth_t, valid_t)

    sq_i = float(np.sqrt(np.float32(sigma)))
    sq_d = float(np.sqrt(np.float32(1.0 - sigma)))
    ez = torch.tensor([0.0, 0.0, 1.0], device=dev)
    eye6 = torch.eye(6, device=dev)

    T = T0
    for _ in range(iterations):
        R = T[:3, :3]
        t = T[:3, 3]
        px = R[0, 0] * xs + R[0, 1] * ys + R[0, 2] * depth_s + t[0]
        py = R[1, 0] * xs + R[1, 1] * ys + R[1, 2] * depth_s + t[1]
        pz = R[2, 0] * xs + R[2, 1] * ys + R[2, 2] * depth_s + t[2]
        pz_safe = torch.clamp(pz, min=1e-6)
        u = fx * px / pz_safe + cx
        v = fy * py / pz_safe + cy

        it_samp, inb1 = _bilinear(intensity_t, u, v)
        dt_samp, dt_ok = _bilinear_valid(depth_t, valid_t, u, v)
        gix, inb2 = _bilinear(gtx, u, v)
        giy, _ = _bilinear(gty, u, v)
        gdx_s, _ = _bilinear(gdx, u, v)
        gdy_s, _ = _bilinear(gdy, u, v)

        r_i = it_samp - intensity_s
        r_d = dt_samp - pz
        ok = (valid_s & inb1 & inb2 & (pz > 0)
              & dt_ok & (dt_samp > 0) & (torch.abs(r_d) < depth_diff_max))
        okf = ok.to(torch.float32)

        # d u / d p' and d p' / d xi = [-[p']x | I]
        iz = 1.0 / pz_safe
        zero = torch.zeros_like(iz)
        du = torch.stack([fx * iz, zero, -fx * px * iz * iz], -1)
        dv = torch.stack([zero, fy * iz, -fy * py * iz * iz], -1)
        p3 = torch.stack([px, py, pz], -1)

        def chain(gu, gv):
            # (H, W, 3) gradient w.r.t. p'; w.r.t. xi the rotational part
            # is p' x g (g^T (-[p']x) = (p' x g)^T), the translational g
            gp = gu[..., None] * du + gv[..., None] * dv
            return torch.cat([torch.linalg.cross(p3, gp), gp], dim=-1)

        J_i = sq_i * chain(gix, giy)
        # geometric: d r_d/dxi = chain(grad depth_t) - d p'_z/dxi
        ez_rot = torch.stack([py, -px, zero], -1)  # p' x e_z
        dz_dxi = torch.cat([ez_rot, ez.expand(px.shape + (3,))], dim=-1)
        J_d = sq_d * (chain(gdx_s, gdy_s) - dz_dxi)
        r_iw = sq_i * r_i
        r_dw = sq_d * r_d

        Jf_i = (J_i * okf[..., None]).reshape(-1, 6)
        Jf_d = (J_d * okf[..., None]).reshape(-1, 6)
        H6 = (torch.matmul(Jf_i.T, Jf_i) + torch.matmul(Jf_d.T, Jf_d))
        g6 = (torch.matmul(Jf_i.T, (r_iw * okf).reshape(-1))
              + torch.matmul(Jf_d.T, (r_dw * okf).reshape(-1)))
        H6 = H6 + 1e-6 * eye6
        dx = -torch.linalg.solve(H6, g6)
        T = se3_exp(dx) @ T
    return T


def rgbd_odometry_multi_scale(
    src_rgb,  # (H, W, 3) in [0,1]
    src_depth,  # (H, W) meters
    tgt_rgb,
    tgt_depth,
    K,  # (3, 3)
    init_T=None,  # (4, 4) T_target_source
    levels: int = 3,
    iterations=(10, 10, 10),  # coarse->fine
    sigma: float = 0.5,
    max_depth: float = 100.0,
    depth_diff_max: float = 0.3,
    device="cuda",
):
    """Estimate T_target_source (maps source-frame points into the target
    camera frame), coarse to fine over `levels` pyramid levels, on
    `device`. Returns a float32 (4, 4) numpy array."""
    dev = resolve_device(device)
    i_s = torch.mean(as_f32(src_rgb, dev), dim=-1)
    i_t = torch.mean(as_f32(tgt_rgb, dev), dim=-1)
    d_s = as_f32(src_depth, dev)
    d_t = as_f32(tgt_depth, dev)
    K = as_f32(K, dev)

    pyr = [(i_s, d_s, i_t, d_t, K)]
    for _ in range(levels - 1):
        i_s = _downsample2(i_s)
        i_t = _downsample2(i_t)
        d_s = _downsample_depth(d_s)
        d_t = _downsample_depth(d_t)
        K = K.clone()
        K[:2, :] *= 0.5
        pyr.append((i_s, d_s, i_t, d_t, K))

    T = as_f32(init_T if init_T is not None else np.eye(4), dev)
    for lvl in reversed(range(levels)):  # coarse -> fine
        i_s, d_s, i_t, d_t, K_l = pyr[lvl]
        # iterations is given coarse->fine: entry 0 applies to the
        # COARSEST level (pyr[levels-1], processed first)
        T = _gn_level(i_s, d_s, i_t, d_t, K_l, T,
                      int(iterations[levels - 1 - lvl]), sigma, max_depth,
                      depth_diff_max)
    return T.cpu().numpy()
