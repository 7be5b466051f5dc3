"""Numerical parity check of the general rasterizer on the current device.

`general_parity` renders one anisotropic scene through the tiled kernels
(backend "pallas", ops/rasterize_tiles.py) and the dense oracle (backend
"reference", ops/rasterize_ref.py) and compares the forward images and the
gradients to the viewmat and to every Gaussian parameter. The gradient
gate is relative to each gradient's scale, not per element.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device

# pass thresholds: forward < 5e-3, gradient rel < 3e-2
FWD_TOL = 5e-3
GRAD_REL_TOL = 3e-2


def general_parity(height: int = 64, width: int = 128, n: int = 300,
                   device=DEFAULT_DEVICE) -> dict:
    """Parity of the GENERAL rasterizer (RGB+ED mode, anisotropic
    quats/scales, gradients to the viewmat AND every Gaussian parameter)
    against the dense oracle on `device`, at a small size.

    Returns fwd_err / a_err (max abs forward differences), grad_rels (per
    argument: max |diff| / max |oracle|), grad_rel (their max) and ok."""
    from ..data.synthetic import random_gaussian_cloud
    from ..models.gaussians import scene_from_point_cloud
    from . import camera
    from .rasterize import rasterize

    dev = resolve_device(device)
    H, W = height, width
    rng = np.random.default_rng(11)
    pts, rgb = random_gaussian_cloud(rng, n)
    scene = scene_from_point_cloud(pts, rgb, device=dev)
    # anisotropic scales + random quats: the general path's full surface
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scene = scene._replace(
        scales=torch.as_tensor(
            rng.uniform(0.02, 0.09, (n, 3)).astype(np.float32), device=dev),
        quats=torch.as_tensor(q, device=dev),
        opacities=torch.full((n,), 0.6, dtype=torch.float32, device=dev),
    )
    K = camera.intrinsics_matrix(0.5 * W, 0.5 * W, W / 2 - 0.5,
                                 H / 2 - 0.5, device=dev)
    vm = torch.eye(4, dtype=torch.float32, device=dev)
    names = ["means", "quats", "scales", "opacities", "sh", "viewmat"]
    args = (scene.means, scene.quats, scene.scales, scene.opacities,
            scene.sh_coeffs, vm)

    def run(backend):
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        means, quats, scales, opas, sh, v = leaves
        r, a = rasterize(means, quats, scales, opas, sh, v, K, W, H,
                         sh_degree=1, render_mode="RGB+ED", backend=backend)
        loss = torch.mean(r ** 2) + 0.05 * torch.mean(a)
        grads = torch.autograd.grad(loss, leaves)
        return r.detach(), a.detach(), grads

    r_o, a_o, g_o = run("reference")
    r_p, a_p, g_p = run("pallas")
    fwd_err = float((r_o - r_p).abs().max())
    a_err = float((a_o - a_p).abs().max())
    rels = {}
    for o, p, name in zip(g_o, g_p, names):
        scale = max(float(o.abs().max()), 1e-12)
        rels[name] = float((o - p).abs().max()) / scale
    grad_rel = max(rels.values())
    ok = fwd_err < FWD_TOL and a_err < FWD_TOL and grad_rel < GRAD_REL_TOL
    return dict(fwd_err=fwd_err, a_err=a_err, grad_rels=rels,
                grad_rel=grad_rel, ok=ok)
