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


def exact_knn_sq_dists(points, k: int = 5):
    """EXACT kNN squared distances over scipy's KdTree (the port uses its
    own C++ tree). points: (N, 3) array or tensor, taken as float64.
    Returns an (N, k) float32 CPU tensor of ascending squared distances,
    column 0 the self-distance 0."""
    import numpy as np
    from scipy.spatial import cKDTree

    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    pts = np.ascontiguousarray(points, np.float64)
    d, _idx = cKDTree(pts).query(pts, k=k, workers=-1)
    return torch.from_numpy((d * d).astype("float32"))


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


