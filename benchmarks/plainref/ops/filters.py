"""Image filters (PyTorch): Sobel edges for the silhouette loss, and the
image-quality metrics PSNR and SSIM."""

from __future__ import annotations

import torch


def sobel_magnitude(img: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(H, W) -> (H, W) Sobel gradient magnitude: normalized kernels
    (divided by 8), replicate padding, sqrt(gx^2 + gy^2 + eps).

    A shift-add stencil, NOT a conv2d: a float32 convolution goes through
    cuDNN, whose TF32 default keeps about three decimal digits; the stencil
    is a handful of exact f32 adds."""
    p = torch.nn.functional.pad(img[None, None], (1, 1, 1, 1),
                                mode="replicate")[0, 0]
    dxc = p[:, 2:] - p[:, :-2]  # (H+2, W) central x-difference
    gx = (dxc[:-2] + 2.0 * dxc[1:-1] + dxc[2:]) * 0.125
    dyc = p[2:, :] - p[:-2, :]  # (H, W+2) central y-difference
    gy = (dyc[:, :-2] + 2.0 * dyc[:, 1:-1] + dyc[:, 2:]) * 0.125
    return torch.sqrt(gx * gx + gy * gy + eps)


