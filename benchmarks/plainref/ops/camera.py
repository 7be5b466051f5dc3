"""Camera / depth-image geometry (PyTorch)."""

from __future__ import annotations

import torch


def depth_to_points(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Back-project an (H, W) depth map to an (H*W, 3) camera-frame cloud.

    Uses the integer pixel grid (u, v in 0..W-1/0..H-1) with NO half-pixel
    offset (the rasterizer itself uses half-pixel centers; that asymmetry
    is part of the method and kept)."""
    H, W = depth.shape
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    u = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :]
    v = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None]
    x = (u - cx) / fx * depth
    y = (v - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1).reshape(-1, 3)


