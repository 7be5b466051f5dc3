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


def psnr(a: torch.Tensor, b: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB."""
    mse = torch.mean((a - b) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-20))


def _gaussian_kernel1d(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    total = k[0]
    for t in range(1, size):  # left to right, as XLA sums the 11 taps
        total = total + k[t]
    return k / total


def _blur_valid(x: torch.Tensor, kern: torch.Tensor, dim: int) -> torch.Tensor:
    """1-D correlation of x with kern along dim, 'valid' mode: a sum of
    shifted slices, taps in ascending order (the kernel is symmetric, so
    this is the convolution too). A shift-add, not a conv: exact f32
    products and sums on every device."""
    n = x.shape[dim] - kern.shape[0] + 1
    out = x.narrow(dim, 0, n) * kern[0]
    for t in range(1, kern.shape[0]):
        out = out + x.narrow(dim, t, n) * kern[t]
    return out


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) or (H, W) image pair: an 11-tap
    Gaussian (sigma 1.5) window applied separably in 'valid' mode, H then
    W, with k1 = 0.01 and k2 = 0.03."""
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    kern = _gaussian_kernel1d(kernel_size, sigma, a.device)

    def blur(x):
        return _blur_valid(_blur_valid(x, kern, 0), kern, 1)

    mu_a, mu_b = blur(a), blur(b)
    mu_aa, mu_bb, mu_ab = blur(a * a), blur(b * b), blur(a * b)
    var_a = mu_aa - mu_a ** 2
    var_b = mu_bb - mu_b ** 2
    cov = mu_ab - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return torch.mean(num / den)
