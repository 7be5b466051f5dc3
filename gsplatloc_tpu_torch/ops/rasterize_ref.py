"""Dense oracle rasterizer (plain PyTorch, autograd) — the correctness anchor.

Evaluates EVERY projected Gaussian at every pixel with exact front-to-back
alpha compositing, gsplat's per-pixel loop semantics (alpha floor 1/255,
ceiling 0.999, transmittance stop at 1e-4). O(N * H * W): for small golden
tests and as the autograd reference of the tiled kernels' backward, not for
production rendering.
"""

from __future__ import annotations

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
T_EPS = 1e-4
ROW_BLOCK = 16  # image rows composited at once: (16*W, N) pairs in memory


def composite_pixels(
    pix_xy: torch.Tensor,  # (P, 2) pixel centres
    mean2d: torch.Tensor,  # (N, 2) depth-ascending order
    conic: torch.Tensor,  # (N, 3)
    opacity: torch.Tensor,  # (N,)
    channels: torch.Tensor,  # (N, C) per-Gaussian channel payload (rgb, z, ...)
    valid: torch.Tensor,  # (N,) bool
):
    """Front-to-back compositing of sorted Gaussians over a block of pixels.

    Returns (out (P, C) accumulated channels, alpha (P,))."""
    dx = pix_xy[:, None, 0] - mean2d[None, :, 0]  # (P, N)
    dy = pix_xy[:, None, 1] - mean2d[None, :, 1]
    sigma = 0.5 * (conic[None, :, 0] * dx * dx + conic[None, :, 2] * dy * dy) + (
        conic[None, :, 1] * dx * dy
    )
    alpha = opacity[None, :] * torch.exp(-sigma)
    alpha = torch.clamp_max(alpha, ALPHA_MAX)
    alpha = torch.where(
        (sigma >= 0.0) & (alpha >= ALPHA_MIN) & valid[None, :], alpha, 0.0)

    # T_prev[n] = prod_{m<n}(1-alpha_m); P_incl[n] = T_prev[n]*(1-alpha_n)
    one_minus = 1.0 - alpha
    p_incl = torch.cumprod(one_minus, dim=1)  # (P, N)
    t_prev = torch.cat([torch.ones_like(p_incl[:, :1]), p_incl[:, :-1]], dim=1)
    # gsplat stops BEFORE accumulating the Gaussian that would push T <= 1e-4
    live = p_incl > T_EPS
    w = torch.where(live, t_prev * alpha, 0.0)  # (P, N)
    out = torch.matmul(w, channels)  # (P, C); TF32 is off in the port
    return out, torch.sum(w, dim=1)


def rasterize_reference(
    mean2d: torch.Tensor,  # (N, 2)
    conic: torch.Tensor,  # (N, 3)
    depth: torch.Tensor,  # (N,) camera z (sort key AND the ED channel)
    opacity: torch.Tensor,  # (N,)
    colors: torch.Tensor,  # (N, C_rgb) evaluated colours (may be C_rgb=0)
    valid: torch.Tensor,  # (N,) bool
    width: int,
    height: int,
):
    """Dense oracle render. Returns (image (H, W, C_rgb+1), alpha (H, W)).

    The last channel of `image` is the UNNORMALIZED accumulated depth; the
    caller divides by clamp(alpha, 1e-10) (ops/rasterize.py, shared with
    the tiled path)."""
    dev = mean2d.device
    sort_depth = torch.where(valid, depth, float("inf"))
    order = torch.argsort(sort_depth.detach(), stable=True)
    mean2d_s = mean2d[order]
    conic_s = conic[order]
    opacity_s = opacity[order]
    valid_s = valid[order]
    channels_s = torch.cat([colors, depth[:, None]], dim=-1)[order]  # (N, C)

    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    outs, alphas = [], []
    for r0 in range(0, height, ROW_BLOCK):
        gy, gx = torch.meshgrid(ys[r0:r0 + ROW_BLOCK], xs, indexing="ij")
        pix = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
        out, al = composite_pixels(pix, mean2d_s, conic_s, opacity_s,
                                   channels_s, valid_s)
        outs.append(out.reshape(gy.shape[0], width, -1))
        alphas.append(al.reshape(gy.shape[0], width))
    return torch.cat(outs, dim=0), torch.cat(alphas, dim=0)
