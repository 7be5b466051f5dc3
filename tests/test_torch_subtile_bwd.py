"""Port vs reference: the backward of the sub-tile render (the kcover=0
tracking path). On the CPU the port's wrappers take their plain PyTorch
versions (`_subtile_bwd_plain` for K5a, `_chain_xla` for K5b); the
reference's backward kernel runs in interpret mode. The reference keeps
its moments inside `_subtile_vjp_bwd`, so the tests read them where it
hands them to its chain phase."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gsplatloc_tpu.data.synthetic import random_gaussian_cloud
from gsplatloc_tpu.models.gaussians import scene_from_point_cloud
from gsplatloc_tpu.ops import camera
from gsplatloc_tpu.ops import fused_subtile as jfs
from gsplatloc_tpu.ops.fused_tracking import cam_vector as j_cam_vector
from gsplatloc_tpu.ops.lie import invert_se3
from gsplatloc_tpu.ops.rasterize import rasterize
from gsplatloc_tpu_torch import kernels
from gsplatloc_tpu_torch.ops import fused_subtile as tfs
from torch_port_helpers import to_np, tt

NEAR, FAR = 1e-2, 1e10
H, W = 32, 128


def _scene(opacity, n=300, seed=4):
    """The reference test's cloud: heterogeneous isotropic scales."""
    rng = np.random.default_rng(seed)
    pts, rgb = random_gaussian_cloud(rng, n)
    scene = scene_from_point_cloud(jnp.asarray(pts), jnp.asarray(rgb))
    s = rng.uniform(0.02, 0.08, (n, 1)).astype(np.float32)
    return scene._replace(scales=jnp.asarray(np.repeat(s, 3, axis=1)),
                          opacities=jnp.full_like(scene.opacities, opacity))


def _viewmat(angles, t):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = Rotation.from_euler("xyz", angles, degrees=True).as_matrix()
    c2w[:3, 3] = t
    return invert_se3(jnp.asarray(c2w))


@functools.lru_cache(maxsize=None)
def _reference_backward(opacity):
    """jax.grad of the reference's sub-tile render under the reference
    test's loss, with the moments and the cam vector its backward built."""
    scene = _scene(opacity)
    K = camera.intrinsics_matrix(70.0, 70.0, W / 2 - 0.5, H / 2 - 0.5)
    vm0 = _viewmat((1, -0.5, 0.8), (0.01, -0.015, 0.02))
    target, _ = rasterize(
        scene.means, scene.quats, scene.scales, scene.opacities,
        scene.sh_coeffs, jnp.eye(4), K, W, H, sh_degree=1, render_mode="ED",
        backend="pallas")
    target = jax.lax.stop_gradient(target[..., 0])
    slot, meta, _ = jfs.build_subtile_slot_buffer(scene, vm0, K, W, H,
                                                  NEAR, FAR)
    seen = {}
    chain = jfs._chain_pallas

    def spy(slot3d, mom, cam, limits, meta_, n_tx):
        seen.update(mom=np.asarray(mom), cam=np.asarray(cam))
        return chain(slot3d, mom, cam, limits, meta_, n_tx)

    def loss(vm):
        d, a = jfs.render_tracking_depth_subtile(vm, K, W, H, slot, meta)
        return jnp.mean((d - target) ** 2) + 0.1 * jnp.mean(a)

    jfs._chain_pallas = spy
    try:
        grad = np.asarray(jax.grad(loss)(vm0))
    finally:
        jfs._chain_pallas = chain
    return dict(grad=grad, slot=np.asarray(slot), meta=np.asarray(meta),
                K=np.asarray(K), vm0=np.asarray(vm0),
                target=np.asarray(target), **seen)


@pytest.fixture(scope="module", params=[1.0, 0.55], ids=["opa1", "opa055"])
def ref(request):
    return _reference_backward(request.param)


def _port_backward(ref):
    """The port's grad under the same loss, with the moments its backward
    produced (the wrappers take their plain versions on the CPU)."""
    seen = {}
    bwd = tfs.subtile_bwd

    def spy(*args):
        seen["mom"] = bwd(*args)
        seen["sin"] = args[1]
        return seen["mom"]

    vm = tt(ref["vm0"]).requires_grad_(True)
    tfs.subtile_bwd = spy
    try:
        d, a = tfs.render_tracking_depth_subtile(
            vm, tt(ref["K"]), W, H, tt(ref["slot"]),
            tt(ref["meta"], torch.int32))
        loss = torch.mean((d - tt(ref["target"])) ** 2) + 0.1 * torch.mean(a)
        loss.backward()
    finally:
        tfs.subtile_bwd = bwd
    return vm.grad.numpy(), seen


def test_dcam_through_subtile_render_matches_jax_grad(ref):
    """d loss / d viewmat through the port's _SubtileRender (plain K5a +
    K5b) vs jax.grad through the reference's custom VJP (interpreted
    backward kernel + chain). The two replay the same recurrence and sum in
    other orders: within 2e-5 of the largest partial (measured <= 6e-7)."""
    g_t, _ = _port_backward(ref)
    g_j = ref["grad"]
    scale = np.abs(g_j[:3]).max()
    assert scale > 0.1
    np.testing.assert_allclose(g_t[:3], g_j[:3], rtol=0, atol=2e-5 * scale)
    np.testing.assert_array_equal(g_t[3], 0.0)


def test_plain_subtile_bwd_matches_reference_moments():
    """K5a's plain version vs the reference kernel's moments on the walked
    range [meta[1], meta[-1]), at opacity 0.55 with the loss's own
    cotangents: rows 0-6 within 1e-5 of each row's largest magnitude, row 7
    (the packed sub-tile origin) equal. The reference scans transmittance
    and the running sum within a chunk in another order; at opacity 0.55,
    1/(1-alpha) <= 2.2 keeps that rounding from being amplified."""
    r = _reference_backward(0.55)
    _g, seen = _port_backward(r)
    mom_t, mom_j = to_np(seen["mom"]), r["mom"]
    lo, hi = int(r["meta"][1]), int(r["meta"][-1])
    assert mom_t.shape == mom_j.shape and hi > lo
    for row in range(7):
        a, d = mom_t[row, lo:hi], mom_j[row, lo:hi]
        assert np.abs(d).max() > 0, row
        assert np.abs(a - d).max() <= 1e-5 * np.abs(d).max(), row
    np.testing.assert_array_equal(mom_t[7, lo:hi], mom_j[7, lo:hi])
    np.testing.assert_array_equal(mom_t[:, hi:], 0.0)


def test_plain_subtile_bwd_is_as_accurate_as_the_reference():
    """Opacity 1 with random cotangents is the ill-conditioned case: the
    adjoint takes suffix = total - running sum and divides it by
    1 - alpha, down to 1e-3, so f32 rounding of the running sums reaches
    ~1e-3 of a moment row. Held against a float64 replay of the same
    recurrence, the port's error is no larger than twice the reference's
    (measured: 6.5e-4 against 6.8e-4)."""
    h, w = 64, 128
    scene = _scene(1.0, n=600)
    K = camera.intrinsics_matrix(70.0, 70.0, w / 2 - 0.5, h / 2 - 0.5)
    slot, meta, _ = jfs.build_subtile_slot_buffer(scene, jnp.eye(4), K, w,
                                                  h, NEAR, FAR)
    n_ty, n_tx = -(-h // 16), -(-w // 128)
    cam = j_cam_vector(_viewmat((1, -0.5, 0.8), (0.01, -0.015, 0.02)), K,
                       w, h)
    p8 = jfs._project8(slot, cam, NEAR, FAR)
    out, _cd = jfs._subtile_fwd_impl(p8, meta, n_ty, n_tx)
    g = np.random.default_rng(0).standard_normal(
        (2, out.shape[1])).astype(np.float32)
    seen = {}
    chain = jfs._chain_pallas

    def spy(slot3d, mom, cam_, limits, meta_, n_tx_):
        seen["mom"] = np.asarray(mom)
        return chain(slot3d, mom, cam_, limits, meta_, n_tx_)

    jfs._chain_pallas = spy
    try:
        jfs._subtile_vjp_bwd(
            n_ty, n_tx, slot.shape[1], NEAR, FAR,
            (slot, p8, meta, cam, out),
            tuple(jfs.unscramble_image(jnp.asarray(x), n_ty, n_tx)
                  for x in g))
    finally:
        jfs._chain_pallas = chain
    sin = tt(np.concatenate([np.asarray(out[:2]), g]))
    args = (tt(p8), sin, tt(meta, torch.int32), n_ty, n_tx)
    mom_t = to_np(tfs._subtile_bwd_plain(*args))
    mom_64 = to_np(tfs._subtile_bwd_plain(args[0].double(), sin.double(),
                                          *args[2:]))
    lo, hi = int(meta[1]), int(meta[-1])

    def err(m):
        return max(np.abs(m[r, lo:hi] - mom_64[r, lo:hi]).max()
                   / np.abs(mom_64[r, lo:hi]).max() for r in range(7))

    assert err(mom_t) <= 2.0 * err(seen["mom"]), (err(mom_t),
                                                  err(seen["mom"]))
    np.testing.assert_array_equal(mom_t[7, lo:hi], seen["mom"][7, lo:hi])


def test_plain_chain_matches_reference_chain(ref):
    """K5b's plain version (`_chain_xla`) vs the reference's on the
    reference's own moments: one f32 sum over every slot in another order,
    within 1e-5 of the largest partial (measured <= 1e-7)."""
    d_j = np.asarray(jfs._chain_xla(
        jnp.asarray(ref["slot"]), jnp.asarray(ref["mom"]),
        jnp.asarray(ref["cam"]), jnp.asarray(ref["meta"]), 1))
    d_t = to_np(tfs._chain_xla(tt(ref["slot"]), tt(ref["mom"]),
                               tt(ref["cam"]), tt(ref["meta"], torch.int32),
                               1))
    assert d_t.shape == d_j.shape == (1, 16)
    np.testing.assert_allclose(d_t, d_j, rtol=0,
                               atol=1e-5 * np.abs(d_j).max())
    np.testing.assert_array_equal(d_t[0, 12:], 0.0)


def test_row7_decodes_to_the_origin_the_plain_chain_rebuilds():
    """The kernel chain decodes each slot's sub-tile origin from moment row
    7; the plain chain rebuilds it from the segment offsets. Both give the
    same origin for every walked slot (meta[0] != 0: a band that starts
    below the first macro-tile row)."""
    n_ty, n_tx = 2, 2
    n_seg = n_ty * n_tx * tfs.N_SUB
    seg_len = np.random.default_rng(1).integers(0, 3, n_seg) * tfs.CHUNK
    meta = np.concatenate([[3], np.concatenate([[0], np.cumsum(seg_len)])])
    meta = tt(meta, torch.int32)
    enc = tfs._segment_enc(meta, n_seg, n_tx)
    ty = torch.floor(enc * (1.0 / tfs.ENC_Y))
    x0, y0 = tfs._segment_origins(meta, n_seg, n_tx)
    np.testing.assert_array_equal(to_np((enc - tfs.ENC_Y * ty) * tfs.SUB_W),
                                  to_np(x0))
    np.testing.assert_array_equal(to_np(ty * tfs.SUB_H), to_np(y0))


def test_unwalked_chunks_hold_zero_moments_like_reference():
    """Opaque wall in front of a deep stack: segment 0 walks one chunk of
    three; the other two, and every slot past meta[-1], are zero in all 8
    rows, as in the reference. The walked chunk agrees with it within 1e-3
    of each row's largest magnitude: random cotangents on an opaque stack
    put the adjoint's running-sum cancellation at ~2e-4 of a row (see
    test_plain_subtile_bwd_is_as_accurate_as_the_reference)."""
    n_ty, n_tx = 1, 1
    m_pad = 8192
    p8 = np.zeros((8, m_pad), np.float32)
    p8[0, :384] = 8.0
    p8[1, :384] = 8.0
    p8[2, :384] = 1e-4
    p8[4, :384] = 1e-4
    p8[5, :384] = np.linspace(1.0, 2.0, 384)
    p8[6, :384] = 0.7
    p8[7, :384] = 1.0
    meta = np.zeros(10, np.int32)
    meta[2:] = 384
    out, _cd = jfs._subtile_fwd_impl(jnp.asarray(p8), jnp.asarray(meta),
                                     n_ty, n_tx)
    g = np.random.default_rng(2).standard_normal(
        (2, out.shape[1])).astype(np.float32)
    sin = tt(np.concatenate([np.asarray(out[:2]), g]))
    mom = to_np(tfs.subtile_bwd(tt(p8), sin, tt(meta, torch.int32), n_ty,
                                n_tx))
    np.testing.assert_array_equal(mom[:, 128:], 0.0)
    assert np.abs(mom[0, :128]).max() > 0
    seen = {}
    chain = jfs._chain_pallas

    def spy(slot3d, mom_, cam, limits, meta_, n_tx_):
        seen["mom"] = np.asarray(mom_)
        return chain(slot3d, mom_, cam, limits, meta_, n_tx_)

    jfs._chain_pallas = spy
    try:
        jfs._subtile_vjp_bwd(
            n_ty, n_tx, m_pad, NEAR, FAR,
            (jnp.zeros((8, m_pad)), jnp.asarray(p8), jnp.asarray(meta),
             jnp.zeros((18,)).at[0:2].set(1.0), out),
            tuple(jfs.unscramble_image(jnp.asarray(x), n_ty, n_tx)
                  for x in g))
    finally:
        jfs._chain_pallas = chain
    np.testing.assert_array_equal(seen["mom"][:, 128:384], 0.0)
    for row in range(7):
        np.testing.assert_allclose(
            mom[row, :128], seen["mom"][row, :128], rtol=0,
            atol=1e-3 * np.abs(seen["mom"][row, :128]).max())


def test_cpu_backward_counts_no_launch():
    kernels.reset_launch_counts()
    ref = _reference_backward(0.55)
    _port_backward(ref)
    counts = kernels.launch_counts()
    assert counts["subtile_bwd"] == counts["subtile_chain"] == 0
    assert kernels._lib is None
