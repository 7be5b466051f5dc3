"""Numerical parity checks of the tracking renderers and of the general
rasterizer on the current device.

`subtile_parity` and `kcover_parity` hold the sub-tile path
(ops/fused_subtile.py) and the K-cover path (ops/kcover.py) against the
full-tile fused path (ops/fused_tracking.py) on a box-room scene: forward
depth/alpha and the gradient of a depth + alpha loss to the viewmat.
`general_parity` renders one anisotropic scene through the tiled kernels
(backend "pallas", ops/rasterize_tiles.py) and the dense oracle (backend
"reference", ops/rasterize_ref.py) and compares the forward images and the
gradients to the viewmat and to every Gaussian parameter. Every gradient
gate is relative to the gradient's scale, not per element: on a card both
sides of a comparison carry f32 noise on heavily-cancelling elements.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device

# pass thresholds: forward < 5e-3, loss rel < 1e-3, gradient rel < 3e-2
FWD_TOL = 5e-3
LOSS_REL_TOL = 1e-3
GRAD_REL_TOL = 3e-2


def _box_room_scene(height, width, dev):
    """The box-room frame at identity as a frozen scene on `dev`.
    Returns (scene, K, viewmat)."""
    from ..data.synthetic import box_room_frame
    from ..models.gaussians import scene_from_point_cloud
    from . import camera
    from .lie import invert_se3

    H, W = height, width
    K_np = np.array([[0.5 * W, 0, W / 2 - 0.5], [0, 0.5 * W, H / 2 - 0.5],
                     [0, 0, 1]], np.float32)
    rgb, depth = box_room_frame(np.eye(4), K_np, H, W)
    K = torch.as_tensor(K_np, device=dev)
    pts = camera.depth_to_points(torch.as_tensor(depth, device=dev), K)
    scene = scene_from_point_cloud(
        pts, torch.as_tensor(rgb.reshape(-1, 3), device=dev),
        grid_shape=(H, W), device=dev)
    vm = invert_se3(torch.eye(4, dtype=torch.float32, device=dev))
    return scene, K, vm


def _against_full_tile(scene, K, vm, W, H, render):
    """Forward and viewmat-gradient comparison of `render(viewmat) ->
    (depth, alpha)` against the full-tile path built at `vm`. Returns the
    numbers both parity checks report."""
    from .fused_tracking import build_slot_buffer, render_tracking_depth

    slot_f, meta_f, _ = build_slot_buffer(scene, vm, K, W, H, 1e-2, 1e10)

    def render_full(v):
        return render_tracking_depth(v, K, W, H, slot_f, meta_f)

    with torch.no_grad():
        d_f, a_f = render_full(vm)
        d_o, a_o = render(vm)
    target = d_f * 1.02  # offset so grads are nonzero

    def value_and_grad(f):
        v = vm.detach().clone().requires_grad_(True)
        d, a = f(v)
        loss = torch.mean((d - target) ** 2) + 0.1 * torch.mean(a)
        (g,) = torch.autograd.grad(loss, v)
        return float(loss.detach()), g[:3, :].cpu().numpy()

    lf, gf = value_and_grad(render_full)
    lo, go = value_and_grad(render)
    scale = max(float(np.abs(gf).max()), 1e-12)
    rel = np.abs(gf - go) / scale
    return dict(
        d_err=float((d_f - d_o).abs().max()),
        a_err=float((a_f - a_o).abs().max()),
        d_n_over=int(((d_f - d_o).abs() > FWD_TOL).sum()),
        loss_full=lf, loss_sub=lo,
        loss_rel=abs(lf - lo) / max(abs(lf), 1e-12),
        grad_rel=float(rel.max()), grad_full=gf, grad_sub=go, rel=rel,
    )


def subtile_parity(height: int = 128, width: int = 256,
                   fwd_tol: float = FWD_TOL, device=DEFAULT_DEVICE) -> dict:
    """Parity of the sub-tile pipeline (ops/fused_subtile.py) against the
    full-tile fused path (ops/fused_tracking.py) on `device`, on the
    box-room frame at identity.

    Returns d_err / a_err (max abs forward differences), d_n_over (pixels
    whose depth differs by more than FWD_TOL: isolated near-threshold gate
    flips, where the full-tile path gates sigma >= 0 and the sub-tile path
    sigma >= -SIG_EPS, against a systematic divergence), loss_full /
    loss_sub / loss_rel, grad_rel (max gradient difference over the
    gradient scale), the two (3, 4) viewmat gradients grad_full /
    grad_sub, rel, and ok (all thresholds met)."""
    from .fused_subtile import (
        build_subtile_slot_buffer, render_tracking_depth_subtile,
    )

    dev = resolve_device(device)
    H, W = height, width
    scene, K, vm = _box_room_scene(H, W, dev)
    slot_s, meta_s, _ = build_subtile_slot_buffer(scene, vm, K, W, H,
                                                  1e-2, 1e10)
    r = _against_full_tile(
        scene, K, vm, W, H,
        lambda v: render_tracking_depth_subtile(v, K, W, H, slot_s, meta_s))
    r["ok"] = (r["d_err"] < fwd_tol and r["a_err"] < fwd_tol
               and r["loss_rel"] < LOSS_REL_TOL
               and r["grad_rel"] < GRAD_REL_TOL)
    return r


def kcover_parity(height: int = 128, width: int = 256, k_cover: int = 16,
                  device=DEFAULT_DEVICE) -> dict:
    """The same check for the K-cover render (ops/kcover.py) against the
    full-tile fused path, at the selection pose (zero staleness: staleness
    is the tracking loop's select_motion_px gate's job), through the
    product rebuild path (budgeted unpadded slot buffer, then
    build_kcover_buffer, whose route follows k_cover: the records select
    at K*5 % 8 == 0, else the index select and a row gather). The
    thresholds are looser than the sub-tile check's: the K-truncation
    drops sub-ALPHA_MIN tails the full walk keeps.

    Returns d_err, a_err, loss_full, loss_sub (the K-cover loss),
    loss_rel, grad_rel, grad_full, grad_sub, rel and ok."""
    from .binning import TILE_H, TILE_W
    from .fused_tracking import cam_vector
    from .kcover import (
        build_kcover_buffer, build_kcover_slot_buffer,
        render_tracking_depth_kcover,
    )

    dev = resolve_device(device)
    H, W = height, width
    scene, K, vm = _box_room_scene(H, W, dev)
    slot_s, meta_s, _ovf = build_kcover_slot_buffer(scene, vm, K, W, H,
                                                    1e-2, 1e10)
    kbuf = build_kcover_buffer(slot_s, meta_s, cam_vector(vm, K, W, H),
                               -(-H // TILE_H), -(-W // TILE_W), 1e-2, 1e10,
                               k_cover=k_cover)
    r = _against_full_tile(
        scene, K, vm, W, H,
        lambda v: render_tracking_depth_kcover(v, K, W, H, kbuf))
    del r["d_n_over"]  # the reference's kcover_parity does not report it
    r["ok"] = (r["d_err"] < 2e-2 and r["a_err"] < 1e-2
               and r["loss_rel"] < 1e-2 and r["grad_rel"] < 5e-2)
    return r


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
