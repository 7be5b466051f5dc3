"""Camera / depth-image geometry (PyTorch)."""

from __future__ import annotations

import torch


def intrinsics_matrix(fx: float, fy: float, cx: float, cy: float,
                      device="cpu") -> torch.Tensor:
    """3x3 K from focal lengths / principal point."""
    return torch.tensor(
        [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device,
    )


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


def points_to_depth_grid(points: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Reshape an (H*W, 3) grid-ordered cloud back to its (H, W, 3) layout."""
    return points.reshape(H, W, 3)


def depth_to_normal(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) unit normal map: cross product of central
    differences of the back-projected point image, replicate padding."""
    H, W = depth.shape
    pts = depth_to_points(depth, K).reshape(H, W, 3)
    padded = torch.nn.functional.pad(
        pts.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate"
    )[0].permute(1, 2, 0)
    dx = padded[1:-1, 2:, :] - padded[1:-1, :-2, :]
    dy = padded[2:, 1:-1, :] - padded[:-2, 1:-1, :]
    n = torch.linalg.cross(dx, dy, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    return n / norm.clamp_min(1e-12)
