"""k-nearest-neighbour distances + Gaussian scale init (PyTorch).

* `grid_knn_sq_dists` — the clouds are dense back-projections of a depth
  image: a point's 3D nearest neighbours lie in a small pixel window around
  it. O(N * window^2), fully vectorized. The hot path (once per frame pair).
* `brute_knn_sq_dists` — exact blocked O(N^2) pairwise distances for
  generic (non-grid) clouds up to ~100k points.
* `exact_knn_sq_dists` — exact kNN over the host C++ KdTree
  (gsplatloc_tpu_torch/native), float64 distances, OpenMP threads; the
  scale init the method was written against, at ~1 s per 816k cloud.

Semantics quirk kept from the method: the kNN search returns SQUARED
distances, and the scale init squares them again — the effective scale is
the RMS of squared neighbour distances. `squared_quirk=False` gives the
textbook version.
"""

from __future__ import annotations

import torch


def grid_knn_sq_dists(point_grid: torch.Tensor, k: int = 5,
                      window: int = 2) -> torch.Tensor:
    """Approximate kNN squared distances for a depth-grid point cloud.

    point_grid: (H, W, 3) back-projected point image. k: neighbours
    INCLUDING self (self distance is 0). window: half-width of the
    candidate pixel window. Returns (H*W, k) squared distances, ascending
    (column 0 is the self-distance 0)."""
    H, W, _ = point_grid.shape
    shifts = [
        (dy, dx)
        for dy in range(-window, window + 1)
        for dx in range(-window, window + 1)
        if not (dy == 0 and dx == 0)
    ]
    big = 3.0e38
    cands = []
    for dy, dx in shifts:
        shifted = torch.full_like(point_grid, big)
        ys = slice(max(dy, 0), H + min(dy, 0))
        yd = slice(max(-dy, 0), H + min(-dy, 0))
        xs = slice(max(dx, 0), W + min(dx, 0))
        xd = slice(max(-dx, 0), W + min(-dx, 0))
        shifted[yd, xd] = point_grid[ys, xs]
        d2 = torch.sum((shifted - point_grid) ** 2, dim=-1)
        cands.append(d2.clamp_max(big))  # inf-pad -> huge finite
    d2_all = torch.stack(cands, dim=-1)  # (H, W, C)
    # k-1 smallest neighbour distances (self contributes the k-th, 0)
    knn_d2, _ = torch.topk(d2_all, k - 1, dim=-1, largest=False, sorted=True)
    zeros = torch.zeros(knn_d2.shape[:-1] + (1,), dtype=knn_d2.dtype,
                        device=knn_d2.device)
    return torch.cat([zeros, knn_d2], dim=-1).reshape(H * W, k)


def brute_knn_sq_dists(points: torch.Tensor, k: int = 5,
                       block: int = 256) -> torch.Tensor:
    """Exact kNN squared distances by blocked pairwise differences.

    points: (N, 3); returns (N, k) ascending squared distances including
    self. Memory O(block * N). Explicit differences, not the
    |a|^2+|b|^2-2ab product form: for dense depth clouds neighbour
    distances are ~1e-3 of the coordinate magnitude and the product form
    loses them to fp32 cancellation."""
    n = points.shape[0]
    out = torch.empty((n, k), dtype=points.dtype, device=points.device)
    for i in range(0, n, block):
        rows = points[i:i + block]
        diff = rows[:, None, :] - points[None, :, :]  # (B, N, 3)
        d2 = torch.sum(diff * diff, dim=-1)
        out[i:i + block] = torch.topk(d2, k, dim=-1, largest=False,
                                      sorted=True).values
    return out


def exact_knn_sq_dists(points, k: int = 5):
    """EXACT kNN squared distances over the host C++ KdTree (built at first
    use; raises RuntimeError when it cannot be built — never falls back to
    another method). points: (N, 3) array or tensor (read on the host, in
    float64). Returns an (N, k) float32 CPU tensor of ascending squared
    distances, column 0 the self-distance 0."""
    from .. import native

    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    _idx, d2 = native.knn(points, points, k)
    return torch.from_numpy(d2.astype("float32"))


def _raw_scales(knn_sq_dists, eps, squared_quirk):
    neigh = knn_sq_dists[:, 1:]
    m = torch.mean(neigh ** 2, dim=-1) if squared_quirk else torch.mean(
        neigh, dim=-1)
    return torch.sqrt(m + eps)


def init_gs_scales_from_sq_dists(
    knn_sq_dists: torch.Tensor, eps: float = 1e-24, squared_quirk: bool = True,
    clamp_quantile: float | None = 0.99, clamp_ratio: float = 64.0
) -> torch.Tensor:
    """Isotropic Gaussian scales from kNN squared distances:
    scale_i = sqrt(mean_j(d2_ij^2) + eps) over neighbours j = 1..k-1 (drops
    the self column), replicated to (N, 3).

    Robust clamp: scales are capped at quantile(scale, clamp_quantile) *
    clamp_ratio, so isolated occlusion fragments (whose neighbours sit far
    away) cannot become image-wide opaque splats. The threshold only
    engages on >= clamp_ratio-fold outliers past the quantile, so healthy
    scenes are untouched; `count_clamped_scales` makes an engaged clamp
    observable. clamp_quantile=None disables."""
    scale = _raw_scales(knn_sq_dists, eps, squared_quirk)
    if clamp_quantile is not None:
        cap = _quantile(scale, clamp_quantile) * clamp_ratio
        scale = torch.minimum(scale, cap)
    return scale[:, None].repeat(1, 3)


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolated quantile by a full sort (torch.quantile caps
    its input size below a full-resolution frame's point count)."""
    xs, _ = torch.sort(x)
    n = xs.shape[0]
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def count_clamped_scales(
    knn_sq_dists: torch.Tensor, eps: float = 1e-24,
    squared_quirk: bool = True, clamp_quantile: float = 0.99,
    clamp_ratio: float = 64.0,
) -> torch.Tensor:
    """Number of splats whose scale the robust clamp would cap (int32
    scalar) — 0 on healthy scenes, where the clamp is bit-inert."""
    scale = _raw_scales(knn_sq_dists, eps, squared_quirk)
    cap = _quantile(scale, clamp_quantile) * clamp_ratio
    return torch.sum(scale > cap).to(torch.int32)


def init_gs_scales_grid(point_grid: torch.Tensor, k: int = 5, window: int = 2,
                        eps: float = 1e-24) -> torch.Tensor:
    """Scale init for a depth-grid cloud (H, W, 3): grid kNN + the scale
    formula of init_gs_scales_from_sq_dists."""
    return init_gs_scales_from_sq_dists(
        grid_knn_sq_dists(point_grid, k, window), eps)


def remove_outliers(points: torch.Tensor, knn_sq_dists=None, k: int = 10,
                    std_ratio: float = 10.0):
    """Statistical outlier mask: the mean kNN distance per point; points
    beyond mean + std_ratio * std (sample std) are outliers. The quirk of
    the method is kept: the "mean distance" is the root of the mean of the
    SQUARED squared distances. Returns (inlier_mask (N,) bool, threshold);
    the caller applies the mask."""
    if knn_sq_dists is None:
        knn_sq_dists = brute_knn_sq_dists(points, k)
    dist_avg = torch.sqrt(torch.mean(knn_sq_dists[:, 1:] ** 2, dim=-1))
    mean = torch.mean(dist_avg)
    std = torch.std(dist_avg, correction=1)
    threshold = mean + std_ratio * std
    return dist_avg < threshold, threshold
