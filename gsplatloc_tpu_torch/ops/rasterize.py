"""Public rasterization API — the gsplat.rasterization equivalent.

`rasterize(...)` takes means/quats/scales/opacities/SH colours + viewmat/K/
width/height with render_mode in {"RGB", "RGB+ED", "ED"} and returns
(render (H, W, C), alpha (H, W)). Differentiable (autograd) w.r.t. the
viewmat (pose gradients) and every Gaussian parameter.

Backends (the reference's names, so a command line written for it runs
unchanged):
  * "reference": dense plain-PyTorch oracle (exact, O(N*H*W), small sizes;
    ops/rasterize_ref.py).
  * "pallas":    the tiled hand-written CUDA kernels with their own
    backward (ops/rasterize_tiles.py); on a CPU tensor their plain PyTorch
    versions.
"""

from __future__ import annotations

import torch

from .projection import project_gaussians
from .rasterize_ref import rasterize_reference
from .sh import eval_sh

ED_ALPHA_EPS = 1e-10


def _view_dirs(means: torch.Tensor, viewmat: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian view directions mean - campos (campos = -R^T t)."""
    R = viewmat[:3, :3]
    campos = -R.T @ viewmat[:3, 3]
    return means - campos


def rasterize(
    means: torch.Tensor,  # (N, 3)
    quats: torch.Tensor,  # (N, 4) wxyz
    scales: torch.Tensor,  # (N, 3)
    opacities: torch.Tensor,  # (N,)
    colors: torch.Tensor,  # (N, K, 3) SH coeffs (sh_degree given) or (N, 3)
    viewmat: torch.Tensor,  # (4, 4) world->camera
    K: torch.Tensor,  # (3, 3)
    width: int,
    height: int,
    sh_degree: int | None = 1,
    near_plane: float = 1e-2,
    far_plane: float = 1e10,
    render_mode: str = "RGB+ED",
    backend: str = "reference",
    mesh=None,
    antialiased: bool = False,
):
    """Render one camera. Returns (render, alpha).

    render channels: RGB -> 3; RGB+ED -> 4 (rgb + alpha-normalized expected
    depth); ED -> 1. ED channel = depth_acc / clamp(alpha, 1e-10).
    antialiased=True applies gsplat's antialiased-mode opacity compensation
    (the method itself runs classic, antialiased=False)."""
    if render_mode not in ("RGB", "RGB+ED", "ED"):
        raise ValueError(f"unsupported render_mode {render_mode}")
    if backend not in ("reference", "pallas"):
        raise ValueError(f"unknown backend {backend}")

    proj = project_gaussians(
        means, quats, scales, viewmat, K, width, height, near_plane,
        far_plane, antialiased=antialiased,
    )
    if antialiased:
        opacities = opacities * proj.opacity_comp

    if render_mode == "ED":
        rgb = torch.zeros((means.shape[0], 0), dtype=means.dtype,
                          device=means.device)
    elif sh_degree is not None:
        rgb = eval_sh(sh_degree, colors, _view_dirs(means, viewmat))
    else:
        rgb = colors

    if backend == "reference":
        image, alpha = rasterize_reference(
            proj.mean2d, proj.conic, proj.depth, opacities, rgb, proj.valid,
            width, height,
        )
    else:
        from .rasterize_tiles import rasterize_tiles

        image, alpha = rasterize_tiles(
            proj.mean2d, proj.conic, proj.depth, opacities, rgb, proj.valid,
            proj.radius, width, height, mesh=mesh,
        )

    # last channel is accumulated depth -> normalize to expected depth
    ed = image[..., -1:] / torch.clamp_min(alpha[..., None], ED_ALPHA_EPS)
    if render_mode == "ED":
        render = ed
    elif render_mode == "RGB+ED":
        render = torch.cat([image[..., :-1], ed], dim=-1)
    else:
        render = image[..., :-1]
    return render, alpha
