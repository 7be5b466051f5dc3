"""The general rasterizer of the port against the JAX package on the CPU:
SH evaluation, the dense oracle, the plain versions of the tiled forward
and backward kernels (held against the reference's Pallas kernels run in
interpret mode on the same JAX-made slot buffer), the slot gather, the
public `rasterize` with gradients to every Gaussian parameter and the
viewmat, the projection's gradients, and `general_parity`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplatloc_tpu.data.synthetic import random_gaussian_cloud
from gsplatloc_tpu.ops import binning as jbinning
from gsplatloc_tpu.ops import projection as jproj
from gsplatloc_tpu.ops import rasterize_pallas as jrp
from gsplatloc_tpu.ops import sh as jsh
from gsplatloc_tpu.ops.rasterize import rasterize as j_rasterize
from gsplatloc_tpu.ops.rasterize_ref import (
    rasterize_reference as j_rasterize_reference,
)
from gsplatloc_tpu_torch import kernels
from gsplatloc_tpu_torch.models.pose import PoseState
from gsplatloc_tpu_torch.ops import projection as tproj
from gsplatloc_tpu_torch.ops import rasterize_tiles as trt
from gsplatloc_tpu_torch.ops import sh as tsh
from gsplatloc_tpu_torch.ops.lie import invert_se3
from gsplatloc_tpu_torch.ops.parity import general_parity
from gsplatloc_tpu_torch.ops.rasterize import rasterize
from gsplatloc_tpu_torch.ops.rasterize_ref import rasterize_reference
from torch_port_helpers import assert_rel, perturbed_c2w, to_np, tt

H, W = 40, 192  # two tile rows (one partial), two tile columns (one partial)


def _cloud(n=180, seed=0, opacity=0.6, aniso=True):
    """A random anisotropic scene as numpy arrays (SH degree 1 with small
    random higher bands, so view-dependent colour has a gradient)."""
    rng = np.random.default_rng(seed)
    pts, rgb = random_gaussian_cloud(rng, n)
    if aniso:
        q = rng.normal(size=(n, 4)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        scales = rng.uniform(0.02, 0.07, (n, 3)).astype(np.float32)
    else:
        q = np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1))
        scales = np.full((n, 3), 0.04, np.float32)
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0] = (rgb - 0.5) / jsh.C0
    sh[:, 1:] = rng.normal(scale=0.1, size=(n, 3, 3)).astype(np.float32)
    return dict(means=pts, quats=q, scales=scales,
                opacities=np.full((n,), opacity, np.float32), sh=sh)


def _K(h, w, f=90.0):
    return np.array([[f, 0, w / 2 - 0.5], [0, f, h / 2 - 0.5], [0, 0, 1]],
                    np.float32)


def _viewmat():
    c2w = perturbed_c2w((2.0, -1.5, 1.0), (0.03, -0.02, 0.05))
    return np.linalg.inv(c2w.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_reference(degree):
    """Within 1e-6: the same polynomial in the same order (f32)."""
    rng = np.random.default_rng(degree)
    coeffs = rng.normal(size=(64, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    out_j = jsh.eval_sh(degree, jnp.asarray(coeffs), jnp.asarray(dirs))
    out_t = tsh.eval_sh(degree, tt(coeffs), tt(dirs))
    np.testing.assert_allclose(to_np(out_t), np.asarray(out_j), atol=1e-6)
    assert float(out_t.min()) >= 0.0
    rgb = rng.uniform(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(to_np(tsh.sh_to_rgb(tsh.rgb_to_sh(tt(rgb)))),
                               rgb, atol=1e-6)


def _projected(c, h, w, vm):
    """Reference projection of scene `c` (numpy outputs) plus its colours."""
    proj = jproj.project_gaussians(
        jnp.asarray(c["means"]), jnp.asarray(c["quats"]),
        jnp.asarray(c["scales"]), jnp.asarray(vm), jnp.asarray(_K(h, w)),
        w, h)
    rgb = jsh.eval_sh(1, jnp.asarray(c["sh"]),
                      jnp.asarray(c["means"]) - jnp.asarray(
                          -vm[:3, :3].T @ vm[:3, 3]))
    return proj, rgb


def test_rasterize_reference_matches_reference():
    """The dense oracle on the same projected splats: images within 1e-5
    (the same front-to-back products; only matmul sum order differs)."""
    c = _cloud(n=120)
    h, w = 24, 40
    proj, rgb = _projected(c, h, w, _viewmat())
    args = (proj.mean2d, proj.conic, proj.depth,
            jnp.asarray(c["opacities"]), rgb, proj.valid)
    img_j, a_j = j_rasterize_reference(*args, w, h)
    targs = [tt(np.asarray(a)) for a in args[:5]] + [
        torch.as_tensor(np.asarray(proj.valid))]
    img_t, a_t = rasterize_reference(*targs, w, h)
    assert bool(a_j.max() > 0.5)
    np.testing.assert_allclose(to_np(a_t), np.asarray(a_j), atol=1e-5)
    np.testing.assert_allclose(to_np(img_t), np.asarray(img_j), atol=1e-5)


@pytest.fixture(scope="module")
def packed():
    """A slot buffer and its meta made by the JAX package (projection,
    binning, record gather), over 2 x 2 tiles."""
    c = _cloud(n=220, seed=3)
    proj, rgb = _projected(c, H, W, _viewmat())
    b = jbinning.bin_and_sort(proj.mean2d, proj.radius, proj.depth,
                              proj.valid, W, H)
    rows = [proj.mean2d[:, 0], proj.mean2d[:, 1], proj.conic[:, 0],
            proj.conic[:, 1], proj.conic[:, 2], proj.depth,
            jnp.asarray(c["opacities"]), rgb[:, 0], rgb[:, 1], rgb[:, 2]]
    rec = jnp.stack(rows + [jnp.zeros_like(proj.depth)] * 6, axis=1)
    kmax = b.inv_perm.shape[0] // rec.shape[0]
    pk = jrp.gather_slots(rec, b.pair_gauss, b.inv_perm, kmax)
    meta = jnp.concatenate([jnp.zeros((1,), jnp.int32), b.tile_starts])
    return dict(rec=rec, b=b, packed=pk, meta=meta, kmax=kmax,
                n_ty=b.n_tiles_y, n_tx=b.n_tiles_x, m_pad=pk.shape[1])


def test_plain_forward_matches_pallas_composite(packed):
    """The plain K6a on the reference's buffer: the five images within
    2e-6 (a sequential transmittance product against the reference's
    in-chunk scan), chunks done equal."""
    p = packed
    outs = jrp._composite_fwd_impl(p["packed"], p["meta"], p["n_ty"],
                                   p["n_tx"], p["m_pad"])
    out_t, cd_t = trt.rasterize_fwd(
        tt(np.asarray(p["packed"])),
        torch.as_tensor(np.asarray(p["meta"])), p["n_ty"], p["n_tx"])
    assert tuple(out_t.shape) == (5, p["n_ty"] * 16, p["n_tx"] * 128)
    for k in range(5):
        np.testing.assert_allclose(to_np(out_t[k]), np.asarray(outs[k]),
                                   atol=2e-6, err_msg=f"channel {k}")
    np.testing.assert_array_equal(to_np(cd_t), np.asarray(outs[5]))
    assert float(out_t[4].max()) > 0.5  # the scene covers pixels


def test_plain_backward_matches_pallas_composite_bwd(packed):
    """The plain K6b against the reference's backward for seeded
    cotangents, and both against a float64 replay of the plain version.
    The port sums the conic and mean terms in the direct form (sum
    d_sigma*dx, ...) and stays within 1e-6 of the float64 replay on every
    row (measured 2.1e-7); the reference expands them into tile-local
    pixel moments, which loses up to 7.3e-4 of a row to cancellation
    (measured, row 2), so against the reference each row holds within
    2e-3 of its largest magnitude, and on rows 0-4 (the expanded ones) the
    port is never the farther of the two from the float64 replay. Opacity
    0.6 keeps 1/(1-alpha) <= 2.5.
    The columns the walk does not reach are zero in both."""
    p = packed
    outs = jrp._composite_fwd_impl(p["packed"], p["meta"], p["n_ty"],
                                   p["n_tx"], p["m_pad"])
    rng = np.random.default_rng(5)
    cots = [rng.standard_normal(np.asarray(outs[0]).shape).astype(np.float32)
            for _ in range(5)]
    g_j, _ = jrp._composite_bwd(
        p["n_ty"], p["n_tx"], p["m_pad"], (p["packed"], p["meta"], outs),
        tuple(jnp.asarray(x) for x in cots))
    px_in = torch.cat([tt(np.stack([np.asarray(o) for o in outs[:5]])),
                       tt(np.stack(cots))])
    g_t = trt.rasterize_bwd(
        tt(np.asarray(p["packed"])), torch.as_tensor(np.asarray(p["meta"])),
        torch.as_tensor(np.asarray(outs[5])), px_in, p["n_ty"], p["n_tx"])
    g_j = np.asarray(g_j)
    g_64 = to_np(trt.rasterize_bwd(
        torch.as_tensor(np.asarray(p["packed"])).double(),
        torch.as_tensor(np.asarray(p["meta"])),
        torch.as_tensor(np.asarray(outs[5])), px_in.double(), p["n_ty"],
        p["n_tx"]))
    assert g_t.shape == g_j.shape == g_64.shape
    for r in range(10):
        assert_rel(g_t[r], g_64[r], 1e-6, f"row {r} vs float64")
        assert_rel(g_t[r], g_j[r], 2e-3, f"row {r} vs reference")
        if r < 5:
            err_t = np.abs(to_np(g_t[r]) - g_64[r]).max()
            assert err_t <= np.abs(g_j[r] - g_64[r]).max(), r
    np.testing.assert_array_equal(to_np(g_t[10:]), 0.0)
    np.testing.assert_array_equal(to_np((g_t == 0).all(dim=0)),
                                  (g_j == 0).all(axis=0))
    assert np.abs(g_j[:10]).max(axis=1).min() > 0  # every row is live


def test_gather_slots_matches_reference(packed):
    """Forward equal (a gather); backward — the inverse-permutation gather
    + kmax-way sum — equal to the reference's to 1e-6."""
    p = packed
    rec_t = tt(np.asarray(p["rec"])).requires_grad_(True)
    out_t = trt.gather_slots(rec_t, torch.as_tensor(np.asarray(
        p["b"].pair_gauss)), torch.as_tensor(np.asarray(p["b"].inv_perm)),
        p["kmax"])
    np.testing.assert_array_equal(to_np(out_t), np.asarray(p["packed"]))
    cot = np.random.default_rng(1).standard_normal(
        out_t.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda r: jrp.gather_slots(
        r, p["b"].pair_gauss, p["b"].inv_perm, p["kmax"]), p["rec"])
    (g_j,) = vjp(jnp.asarray(cot))
    (g_t,) = torch.autograd.grad(out_t, rec_t, tt(cot))
    np.testing.assert_allclose(to_np(g_t), np.asarray(g_j), atol=1e-6)


def test_rasterize_tiles_refuses_a_mesh():
    """A mesh must be a TileMesh (parallel/sharded.py); anything else is
    refused before any work (the banded render itself is held in
    tests/test_torch_sharded.py)."""
    n = 4
    z = torch.zeros((n, 2))
    with pytest.raises(TypeError, match="TileMesh"):
        trt.rasterize_tiles(z, torch.zeros((n, 3)), torch.ones(n),
                            torch.ones(n), torch.zeros((n, 3)),
                            torch.ones(n, dtype=torch.bool),
                            torch.ones(n, dtype=torch.int32), 8, 8,
                            mesh=object())


def _grads_j(c, K, vm, h, w, mode, aa):
    def loss(means, quats, scales, opas, sh, v):
        r, a = j_rasterize(means, quats, scales, opas, sh, v, K, w, h,
                           sh_degree=1, render_mode=mode,
                           backend="reference", antialiased=aa)
        return jnp.mean(r ** 2) + 0.05 * jnp.mean(a), (r, a)

    args = [jnp.asarray(c[k]) for k in ("means", "quats", "scales",
                                        "opacities", "sh")] + [
        jnp.asarray(vm)]
    (_, (r, a)), g = jax.value_and_grad(
        loss, argnums=tuple(range(6)), has_aux=True)(*args)
    return np.asarray(r), np.asarray(a), [np.asarray(x) for x in g]


def _grads_t(c, K, vm, h, w, mode, aa, backend):
    leaves = [tt(c[k]).requires_grad_(True) for k in (
        "means", "quats", "scales", "opacities", "sh")] + [
        tt(vm).requires_grad_(True)]
    r, a = rasterize(*leaves, tt(K), w, h, sh_degree=1, render_mode=mode,
                     backend=backend, antialiased=aa)
    loss = torch.mean(r ** 2) + 0.05 * torch.mean(a)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # ED mode reads no colour: the SH gradient is zero, as jax.grad gives
    return r, a, [torch.zeros_like(x) if g is None else g
                  for g, x in zip(grads, leaves)]


@pytest.mark.parametrize("aa", [False, True], ids=["classic", "antialiased"])
@pytest.mark.parametrize("mode", ["RGB", "RGB+ED", "ED"])
def test_rasterize_matches_reference(mode, aa):
    """Port backends "pallas" (plain K6a/K6b + gather + autograd through
    projection and SH) and "reference" against the JAX oracle on one
    anisotropic scene over 2 x 2 tiles: render within 2e-4, alpha within
    2e-5 (the reference's own pallas-vs-oracle tolerances), and every
    gradient — means, quats, scales, opacities, SH, viewmat — within 5e-4
    of its largest magnitude (tighter than the reference's 5e-3 rtol /
    5e-4 x scale atol)."""
    c = _cloud(n=160, seed=7)
    K, vm = _K(H, W), _viewmat()
    r_j, a_j, g_j = _grads_j(c, jnp.asarray(K), vm, H, W, mode, aa)
    assert a_j.max() > 0.5
    names = ["means", "quats", "scales", "opacities", "sh", "viewmat"]
    for backend in ("pallas", "reference"):
        r_t, a_t, g_t = _grads_t(c, K, vm, H, W, mode, aa, backend)
        assert r_t.shape == r_j.shape
        np.testing.assert_allclose(to_np(a_t), a_j, atol=2e-5)
        np.testing.assert_allclose(to_np(r_t), r_j, atol=2e-4)
        for name, gt, gj in zip(names, g_t, g_j):
            assert_rel(gt, gj, 5e-4, f"{backend} {name}")


@pytest.mark.parametrize("backend", ["pallas", "reference"])
def test_single_gaussian_centre_colour_and_depth(backend):
    """One opaque Gaussian straight ahead: the centre pixel is its colour
    and its depth."""
    sh = np.zeros((1, 4, 3), np.float32)
    sh[0, 0] = (np.array([0.2, 0.5, 0.9]) - 0.5) / jsh.C0
    K = np.array([[50.0, 0, 16.0], [0, 50.0, 16.0], [0, 0, 1]], np.float32)
    r, a = rasterize(tt([[0.0, 0.0, 2.0]]), tt([[1.0, 0, 0, 0]]),
                     tt([[0.3, 0.3, 0.3]]), tt([1.0]), tt(sh), torch.eye(4),
                     tt(K), 33, 33, sh_degree=1, render_mode="RGB+ED",
                     backend=backend)
    centre, alpha = to_np(r[16, 16]), float(a[16, 16])
    assert alpha > 0.99
    np.testing.assert_allclose(centre[:3] / alpha, [0.2, 0.5, 0.9], atol=1e-5)
    np.testing.assert_allclose(centre[3], 2.0, atol=1e-3)


@pytest.mark.parametrize("backend", ["pallas", "reference"])
def test_front_to_back_occlusion(backend):
    """A near red Gaussian occludes a far blue one on the same ray."""
    sh = np.zeros((2, 4, 3), np.float32)
    sh[0, 0] = (np.array([1.0, 0.0, 0.0]) - 0.5) / jsh.C0
    sh[1, 0] = (np.array([0.0, 0.0, 1.0]) - 0.5) / jsh.C0
    K = np.array([[30.0, 0, 8.0], [0, 30.0, 8.0], [0, 0, 1]], np.float32)
    r, _ = rasterize(tt([[0.0, 0.0, 1.5], [0.0, 0.0, 3.0]]),
                     tt([[1.0, 0, 0, 0]] * 2), tt(np.full((2, 3), 0.2)),
                     tt([1.0, 1.0]), tt(sh), torch.eye(4), tt(K), 17, 17,
                     sh_degree=1, render_mode="RGB+ED", backend=backend)
    c = to_np(r[8, 8])
    assert c[0] > 0.95 and c[2] < 0.05
    np.testing.assert_allclose(c[3], 1.5, atol=0.05)


@pytest.mark.parametrize("backend", ["pallas", "reference"])
def test_pose_gradients_match_finite_differences(backend):
    """Autograd through the port's render against central differences in
    the smooth regime (a few big overlapping splats, alpha far from every
    gate): within 5 % relative / 2 % of the largest component."""
    rng = np.random.default_rng(3)
    n, h, w = 6, 16, 16
    pts = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                    rng.uniform(2.2, 3.0, n)], axis=1).astype(np.float32)
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0] = (rng.uniform(0.2, 0.8, (n, 3)) - 0.5) / jsh.C0
    args = (tt(pts), tt(np.tile([[1.0, 0, 0, 0]], (n, 1))),
            tt(np.full((n, 3), 2.0)), tt(np.full((n,), 0.5)), tt(sh))
    K = tt([[20.0, 0, w / 2 - 0.5], [0, 20.0, h / 2 - 0.5], [0, 0, 1]])
    with torch.no_grad():
        target = rasterize(*args, torch.eye(4), K, w, h, render_mode="ED",
                           backend=backend)[0] * 1.02

    def loss_at(quat, trans):
        vm = invert_se3(PoseState(quat, trans).to_c2w())
        r, _ = rasterize(*args, vm, K, w, h, render_mode="ED",
                         backend=backend)
        return torch.mean((r - target) ** 2)

    q0 = tt([0.9995, 0.008, -0.006, 0.007]).requires_grad_(True)
    t0 = tt([0.004, -0.006, 0.008]).requires_grad_(True)
    g = torch.cat(torch.autograd.grad(loss_at(q0, t0), (q0, t0))).numpy()
    eps = 1e-3
    fd = []
    with torch.no_grad():
        for i in range(7):
            d = torch.zeros(7)
            d[i] = eps
            q, t = q0.detach(), t0.detach()
            fd.append(float((loss_at(q + d[:4], t + d[4:])
                             - loss_at(q - d[:4], t - d[4:])) / (2 * eps)))
    fd = np.asarray(fd)
    scale = np.abs(fd).max()
    assert scale > 1e-5
    np.testing.assert_allclose(g, fd, rtol=0.05, atol=0.02 * scale)


@pytest.mark.parametrize("aa", [False, True], ids=["classic", "antialiased"])
def test_project_gaussians_gradients_match_reference(aa):
    """Gradients of a weighted sum of every projected output (mean2d,
    conic, depth and, antialiased, the opacity compensation) w.r.t. means,
    quats, scales and the viewmat: within 1e-4 of each gradient's largest
    magnitude (the forward agrees to f32 rounding; conics reach 1e3)."""
    c = _cloud(n=64, seed=9)
    K, vm = _K(H, W), _viewmat()
    wts = np.random.default_rng(2).standard_normal((64, 6)).astype(np.float32)

    def loss_j(means, quats, scales, v):
        p = jproj.project_gaussians(means, quats, scales, v, jnp.asarray(K),
                                    W, H, antialiased=aa)
        out = jnp.concatenate([p.mean2d, p.conic, p.depth[:, None]], axis=1)
        tot = jnp.sum(jnp.where(p.valid[:, None], out * wts, 0.0))
        if aa:
            tot = tot + jnp.sum(jnp.where(p.valid, p.opacity_comp, 0.0))
        return tot

    args = [c["means"], c["quats"], c["scales"], vm]
    g_j = jax.grad(loss_j, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(a) for a in args])
    leaves = [tt(a).requires_grad_(True) for a in args]
    p = tproj.project_gaussians(*leaves[:3], leaves[3], tt(K), W, H,
                                antialiased=aa)
    out = torch.cat([p.mean2d, p.conic, p.depth[:, None]], dim=1)
    tot = torch.sum(torch.where(p.valid[:, None], out * tt(wts), 0.0))
    if aa:
        tot = tot + torch.sum(torch.where(p.valid, p.opacity_comp, 0.0))
    g_t = torch.autograd.grad(tot, leaves)
    assert bool(p.valid.any())
    for name, gt, gj in zip(["means", "quats", "scales", "viewmat"], g_t, g_j):
        assert_rel(gt, gj, 1e-4, name)


def test_general_parity_on_the_cpu():
    """The port's general_parity (the check chip_smoke.py runs on the
    card) passes on the CPU through the plain versions, with no launch."""
    kernels.reset_launch_counts()
    r = general_parity(height=32, width=128, n=150, device="cpu")
    assert r["ok"], r
    assert set(r["grad_rels"]) == {"means", "quats", "scales", "opacities",
                                   "sh", "viewmat"}
    counts = kernels.launch_counts()
    assert counts["rasterize_fwd"] == counts["rasterize_bwd"] == 0
