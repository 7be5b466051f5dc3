"""Tracking losses (PyTorch).

total = depth_lambda * L1(depth) + (1 - depth_lambda - normal_lambda) *
        L1(sobel edges), with zero-rendered-depth pixels masked by
        MULTIPLYING both images by the (no-grad) mask and averaging over
        ALL pixels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ops.filters import sobel_magnitude


def _reduce(diff: torch.Tensor, loss_type: str) -> torch.Tensor:
    if loss_type == "l1":
        return torch.mean(torch.abs(diff))
    if loss_type == "mse":
        return torch.mean(diff * diff)
    raise ValueError(f"invalid loss type {loss_type}")


def depth_loss(depth_a, depth_b, loss_type: str = "l1"):
    """Mean |a-b| (or squared) over all pixels."""
    return _reduce(depth_a - depth_b, loss_type)


def silhouette_loss(depth_a, depth_b, loss_type: str = "l1"):
    """Sobel-edge distance between (H, W) depth images."""
    return _reduce(sobel_magnitude(depth_a) - sobel_magnitude(depth_b), loss_type)


class TrackingLoss(NamedTuple):
    total: torch.Tensor
    depth: torch.Tensor
    silhouette: torch.Tensor


def tracking_loss(
    rendered_depth: torch.Tensor,  # (H, W)
    gt_depth: torch.Tensor,  # (H, W)
    depth_lambda: float = 0.8,
    normal_lambda: float = 0.0,
    loss_type: str = "l1",
) -> TrackingLoss:
    """Masked depth + silhouette objective. The mask (rendered depth != 0)
    is a no-grad factor applied to BOTH images before the losses. A zero
    silhouette weight skips the Sobel stencils (the silhouette diagnostic
    is then reported as 0)."""
    with torch.no_grad():
        mask = (rendered_depth != 0.0).to(rendered_depth.dtype)
    d = rendered_depth * mask
    g = gt_depth * mask
    dl = depth_loss(d, g, loss_type)
    sil_w = 1.0 - depth_lambda - normal_lambda
    if float(sil_w) == 0.0:
        sl = torch.zeros_like(dl)
    else:
        sl = silhouette_loss(d, g, loss_type)
    total = dl * depth_lambda + sl * sil_w
    return TrackingLoss(total=total, depth=dl, silhouette=sl)
