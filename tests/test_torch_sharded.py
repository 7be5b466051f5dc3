"""Tile-row bands over several devices (the port's parallel/): each band
run against the port's single-device run, and against the JAX package's
own sharded function on the conftest's virtual CPU devices, with the same
inputs made from a numpy seed.

The port's bands run on a TileMesh of repeated CPU devices; the JAX
package's over make_tile_mesh(n) of the 8 virtual devices. The band
forwards are bit-equal to the single-device ones: every band runs the
single-device walk on its own rows with its global row offset, so each
pixel sees the same operations. The gradients sum the band partials in
band order where the single device sums them all at once: rtol 1e-4,
atol 1e-7 (the JAX package's gate in tests/test_sharded.py). Port
against JAX: the tolerances of the port's single-device parity tests of
the same render (named at each use)."""

import json
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplatloc_tpu.data.synthetic import random_gaussian_cloud
from gsplatloc_tpu.models.gaussians import scene_from_point_cloud
from gsplatloc_tpu.models.pose import PoseState as JPose
from gsplatloc_tpu.ops import camera
from gsplatloc_tpu.ops import fused_subtile as jfs
from gsplatloc_tpu.ops import fused_tracking as jft
from gsplatloc_tpu.ops import kcover as jkc
from gsplatloc_tpu.ops.lie import invert_se3 as j_invert
from gsplatloc_tpu.ops.rasterize import rasterize as j_rasterize
from gsplatloc_tpu.opt.tracking import TrackingConfig as JConfig
from gsplatloc_tpu.opt.tracking import optimize_pose as j_optimize_pose
from gsplatloc_tpu.parallel.sharded import make_tile_mesh as j_mesh
from gsplatloc_tpu_torch.convert import config_from_reference, scene_from_numpy
from gsplatloc_tpu_torch.models.pose import PoseState
from gsplatloc_tpu_torch.ops import fused_subtile as tfs
from gsplatloc_tpu_torch.ops import fused_tracking as tft
from gsplatloc_tpu_torch.ops import kcover as tkc
from gsplatloc_tpu_torch.ops.lie import invert_se3
from gsplatloc_tpu_torch.ops.rasterize import rasterize
from gsplatloc_tpu_torch.opt.tracking import TrackingConfig, optimize_pose
from gsplatloc_tpu_torch.parallel import (
    global_tile_mesh, initialize, make_tile_mesh, shard_scenes,
)
from gsplatloc_tpu_torch.parallel.sharded import TileMesh
from helpers import assert_close_except_gate_flips
from torch_port_helpers import assert_rel, to_np, tt

ROOT = Path(__file__).resolve().parents[1]
NEAR, FAR = 1e-2, 1e10
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7


def _scene(n=300, seed=0):
    """The JAX package's mesh tests' scene (random cloud, scale 0.05) in
    both packages."""
    rng = np.random.default_rng(seed)
    pts, rgb = random_gaussian_cloud(rng, n)
    sj = scene_from_point_cloud(jnp.asarray(pts), jnp.asarray(rgb))
    sj = sj._replace(scales=jnp.full_like(sj.scales, 0.05))
    st = scene_from_numpy({k: np.asarray(getattr(sj, k)) for k in sj._fields},
                          device="cpu")
    return sj, st


def _K(h, w):
    return np.asarray(camera.intrinsics_matrix(60.0, 60.0, w / 2 - 0.5,
                                               h / 2 - 0.5), np.float32)


def _mesh(n):
    return make_tile_mesh(devices=["cpu"] * n)


def _grad_close(actual, desired, what=""):
    np.testing.assert_allclose(to_np(actual), to_np(desired), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL, err_msg=what)


# ---------------------------------------------------------------------------
# the general rasterizer (backend "pallas": K6a / K6b per band)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev,h", [(2, 64), (4, 128), (2, 48)],
                         ids=["2", "4", "2-padded"])
def test_sharded_forward_matches_single(n_dev, h):
    """RGB+ED render in bands (2 tile rows a band; "2-padded": 3 tile rows
    padded to 4 with an empty row): bit-equal to one device; against the
    JAX package's sharded render within the general parity test's bounds
    (render 2e-4, alpha 2e-5)."""
    w = 128
    sj, st = _scene()
    K = _K(h, w)
    out = {}
    for m in (None, _mesh(n_dev)):
        out[m is None] = rasterize(
            st.means, st.quats, st.scales, st.opacities, st.sh_coeffs,
            torch.eye(4), tt(K), w, h, sh_degree=1, render_mode="RGB+ED",
            backend="pallas", mesh=m)
    (r1, a1), (r2, a2) = out[True], out[False]
    assert torch.equal(r2, r1) and torch.equal(a2, a1)
    assert float(a1.max()) > 0.5
    rj, aj = j_rasterize(sj.means, sj.quats, sj.scales, sj.opacities,
                         sj.sh_coeffs, jnp.eye(4), jnp.asarray(K), w, h,
                         sh_degree=1, render_mode="RGB+ED", backend="pallas",
                         mesh=j_mesh(n_dev))
    np.testing.assert_allclose(to_np(a2), np.asarray(aj), atol=2e-5)
    np.testing.assert_allclose(to_np(r2), np.asarray(rj), atol=2e-4)


def test_sharded_pose_grads_match_single():
    """Pose gradients (quat, trans) of an ED loss through the banded
    general render: the record gradients are summed in band order; against
    the JAX package's sharded gradients within the general parity test's
    5e-4 of the largest magnitude."""
    n_dev = 4
    h, w = 16 * n_dev, 128
    sj, st = _scene(seed=3)
    K = _K(h, w)
    target, _ = rasterize(st.means, st.quats, st.scales, st.opacities,
                          st.sh_coeffs, torch.eye(4), tt(K), w, h,
                          sh_degree=1, render_mode="ED", backend="pallas")
    q0 = np.array([0.9995, 0.01, -0.008, 0.012], np.float32)
    t0 = np.array([0.01, -0.015, 0.02], np.float32)

    def grads(m):
        q, t = tt(q0).requires_grad_(True), tt(t0).requires_grad_(True)
        vm = invert_se3(PoseState(quat=q, trans=t).to_c2w())
        r, _ = rasterize(st.means, st.quats, st.scales, st.opacities,
                         st.sh_coeffs, vm, tt(K), w, h, sh_degree=1,
                         render_mode="ED", backend="pallas", mesh=m)
        return torch.autograd.grad(torch.mean((r - target.detach()) ** 2),
                                   (q, t))

    g1, g2 = grads(None), grads(_mesh(n_dev))
    for a, b in zip(g1, g2):
        _grad_close(b, a)

    tj = jnp.asarray(to_np(target))

    def loss_j(q, t):
        vm = j_invert(JPose(quat=q, trans=t).to_c2w())
        r, _ = j_rasterize(sj.means, sj.quats, sj.scales, sj.opacities,
                           sj.sh_coeffs, vm, jnp.asarray(K), w, h,
                           sh_degree=1, render_mode="ED", backend="pallas",
                           mesh=j_mesh(n_dev))
        return jnp.mean((r - tj) ** 2)

    gj = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(q0), jnp.asarray(t0))
    for a, b in zip(g2, gj):
        assert_rel(a, b, 5e-4)


def _target_at_identity(st, K, w, h):
    slot, meta, _ = tfs.build_subtile_slot_buffer(st, torch.eye(4), tt(K), w,
                                                  h, NEAR, FAR)
    d, _ = tfs.render_tracking_depth_subtile(torch.eye(4), tt(K), w, h,
                                             slot, meta)
    return to_np(d)


def _steps(st, sj, K, w, h, kw, backend="fused", n_dev=4):
    """optimize_pose of both packages from identity towards 1.01 x the
    identity depth: the port on one device and in bands, the JAX package
    over its virtual devices."""
    target = _target_at_identity(st, K, w, h) * 1.01
    cfg_j = JConfig(**kw)
    cfg = config_from_reference(cfg_j)
    res = {m is None: optimize_pose(st, np.eye(4, dtype=np.float32), target,
                                    K, w, h, config=cfg, backend=backend,
                                    device="cpu", mesh=m)
           for m in (None, _mesh(n_dev))}
    rj = j_optimize_pose(sj, jnp.eye(4), jnp.asarray(target),
                         jnp.asarray(K), w, h, config=cfg_j, backend=backend,
                         mesh=j_mesh(n_dev))
    return res[True], res[False], rj


def _check_steps(single, banded, rj, steps, pose_atol_single, pose_atol_j):
    assert single.steps_run == banded.steps_run == int(rj.steps_run) == steps
    assert (single.rebuilds, single.selects) == (banded.rebuilds,
                                                 banded.selects)
    assert (banded.rebuilds, banded.selects) == (int(rj.rebuilds),
                                                 int(rj.selects))
    assert bool(torch.isfinite(banded.final_pose.trans).all())
    assert float(banded.final_pose.trans.abs().max()) > 0
    for f in ("quat", "trans"):
        b = getattr(banded.final_pose, f)
        np.testing.assert_allclose(to_np(b),
                                   to_np(getattr(single.final_pose, f)),
                                   atol=pose_atol_single, rtol=0)
        np.testing.assert_allclose(to_np(b), np.asarray(
            getattr(rj.final_pose, f)), atol=pose_atol_j, rtol=0)


def test_dryrun_multichip_general_step():
    """Two steps of the general tracking loop in 4 bands (the JAX package's
    dryrun_multichip): bit-equal to one device (the record gradients of
    the bands touch disjoint slots), within the general tracking parity
    test's 1e-6 of the JAX package's."""
    h, w = 64, 128
    sj, st = _scene(n=512, seed=1)
    single, banded, rj = _steps(
        st, sj, _K(h, w), w, h,
        dict(max_steps=2, patience=10, warmup_steps=0), backend="pallas")
    _check_steps(single, banded, rj, 2, 0.0, 1e-6)


def test_optimize_pose_recorded_in_bands_equals_one_device():
    """The diagnostic harness on the general path in 2 bands: every
    per-step series and the final pose bit-equal to one device's, and
    within the general tracking parity test's bounds (loss rtol 1e-5, pose
    1e-6) of the JAX package's sharded run."""
    from gsplatloc_tpu.opt.tracking import (
        optimize_pose_recorded as j_recorded,
    )
    from gsplatloc_tpu_torch.opt.tracking import optimize_pose_recorded

    h, w = 32, 128
    sj, st = _scene(n=200, seed=2)
    K = _K(h, w)
    target = _target_at_identity(st, K, w, h) * 1.01
    cfg = JConfig(max_steps=3)
    out = {m is None: optimize_pose_recorded(
        st, np.eye(4, dtype=np.float32), target, K, w, h, n_steps=3,
        config=config_from_reference(cfg), device="cpu", mesh=m)
        for m in (None, _mesh(2))}
    for k in ("loss", "depth_loss", "silhouette_loss", "quat", "trans"):
        assert torch.equal(out[False][k], out[True][k]), k
    assert torch.equal(out[False]["final_pose"].trans,
                       out[True]["final_pose"].trans)
    rj = j_recorded(sj, jnp.eye(4), jnp.asarray(target), jnp.asarray(K), w,
                    h, n_steps=3, config=cfg, mesh=j_mesh(2))
    np.testing.assert_allclose(to_np(out[False]["loss"]),
                               np.asarray(rj["loss"]), rtol=1e-5)
    np.testing.assert_allclose(to_np(out[False]["final_pose"].trans),
                               np.asarray(rj["final_pose"].trans), atol=1e-6)


# ---------------------------------------------------------------------------
# the full-tile path (K7a / K7b per band)
# ---------------------------------------------------------------------------

def _render_and_grads(render, n_dev, what):
    """render(vm, mesh) -> (depth, alpha): forwards bit-equal, the viewmat
    gradient of the JAX package's test loss within rtol 1e-4 / atol 1e-7.
    Returns the banded (depth, alpha, grad)."""
    vm0 = torch.eye(4)
    d1, a1 = render(vm0, None)
    d2, a2 = render(vm0, _mesh(n_dev))
    assert torch.equal(d2, d1) and torch.equal(a2, a1), what
    assert float(a1.mean()) > 0.2
    target = d1.detach()

    def grad(m):
        vm = vm0.clone().requires_grad_(True)
        d, a = render(vm, m)
        loss = torch.mean((d - target * 1.01) ** 2) + 0.05 * torch.mean(a)
        return torch.autograd.grad(loss, vm)[0]

    g1, g2 = grad(None), grad(_mesh(n_dev))
    assert float(g1[:3].abs().max()) > 0
    _grad_close(g2, g1, what)
    return d2, a2, g2


def _jax_render_and_grad(render_j, n_dev):
    """The JAX package's sharded render and the gradient of the same loss
    (jitted: eager shard_map dispatch is slow on the CPU)."""
    mesh = j_mesh(n_dev)
    vm0 = jnp.eye(4)
    target = jax.lax.stop_gradient(jax.jit(lambda v: render_j(v, None))(vm0)[0])

    def loss(vm):
        dd, aa = render_j(vm, mesh)
        return (jnp.mean((dd - target * 1.01) ** 2) + 0.05 * jnp.mean(aa),
                (dd, aa))

    g, (d, a) = jax.jit(jax.grad(loss, has_aux=True))(vm0)
    return np.asarray(d), np.asarray(a), np.asarray(g)


def test_sharded_fused_render_and_grads():
    """render_tracking_depth in 4 bands over the JAX package's slot buffer;
    against the JAX package's sharded render within the full-tile parity
    tests' bounds (alpha 3e-5 and depth 3e-4 but gate flips; gradient rtol
    3e-3, atol 3e-4 of its scale)."""
    n_dev = 4
    h, w = 16 * n_dev, 128
    sj, _ = _scene(seed=5)
    K = _K(h, w)
    slot, meta, _ = jft.build_slot_buffer(sj, jnp.eye(4), jnp.asarray(K), w,
                                          h, NEAR, FAR)
    slot_t, meta_t = tt(slot), tt(meta, torch.int32)

    d, a, g = _render_and_grads(
        lambda vm, m: tft.render_tracking_depth(vm, tt(K), w, h, slot_t,
                                                meta_t, mesh=m),
        n_dev, "full-tile")
    dj, aj, gj = _jax_render_and_grad(
        lambda vm, m: jft.render_tracking_depth(vm, jnp.asarray(K), w, h,
                                                slot, meta, mesh=m), n_dev)
    assert_close_except_gate_flips(to_np(a), aj, atol=3e-5)
    assert_close_except_gate_flips(to_np(d), dj, atol=3e-4, flip_abs=0.3)
    scale = np.abs(gj[:3]).max()
    np.testing.assert_allclose(to_np(g)[:3], gj[:3], rtol=3e-3,
                               atol=3e-4 * scale)


def test_dryrun_multichip_fused_step():
    """Two full-tile steps in 4 bands: the pose within 1e-6 of one
    device's (the pose gradients differ in their last bits), within the
    full-tile tracking parity test's 1e-4 of the JAX package's."""
    h, w = 64, 128
    sj, st = _scene(seed=6)
    single, banded, rj = _steps(
        st, sj, _K(h, w), w, h,
        dict(max_steps=2, patience=10, warmup_steps=0, resort_every=100,
             kcover=0, subtile=False))
    _check_steps(single, banded, rj, 2, 1e-6, 1e-4)


def test_compaction_is_off_under_a_mesh(monkeypatch):
    """compact=True probes (K7c) on one device, never in bands (as the JAX
    package's `do_compact` rules)."""
    from gsplatloc_tpu_torch.ops import fused_tracking

    calls = []
    probe = fused_tracking.fused_probe
    monkeypatch.setattr(fused_tracking, "fused_probe",
                        lambda *a, **k: calls.append(1) or probe(*a, **k))
    h, w = 64, 128
    _, st = _scene(seed=6)
    K = _K(h, w)
    target = _target_at_identity(st, K, w, h)
    cfg = TrackingConfig(max_steps=2, warmup_steps=0, subtile=False,
                         compact=True)
    for m, want in ((None, 1), (_mesh(2), 0)):
        calls.clear()
        res = optimize_pose(st, np.eye(4, dtype=np.float32), target, K, w, h,
                            config=cfg, device="cpu", mesh=m)
        assert res.steps_run == 2 and len(calls) == want


# ---------------------------------------------------------------------------
# the sub-tile path (K4a, K4b, K5a, K5b per band)
# ---------------------------------------------------------------------------

def test_sharded_subtile_render_and_grads():
    """render_tracking_depth_subtile in 4 bands over the JAX package's slot
    buffer; against its sharded render within the sub-tile parity tests'
    bounds (alpha 3e-5 and depth 3e-4 but gate flips; gradient 2e-5 of its
    largest partial)."""
    n_dev = 4
    h, w = 16 * n_dev, 128
    sj, _ = _scene(seed=7)
    K = _K(h, w)
    slot, meta, _ = jfs.build_subtile_slot_buffer(sj, jnp.eye(4),
                                                  jnp.asarray(K), w, h,
                                                  NEAR, FAR)
    slot_t, meta_t = tt(slot), tt(meta, torch.int32)
    d, a, g = _render_and_grads(
        lambda vm, m: tfs.render_tracking_depth_subtile(
            vm, tt(K), w, h, slot_t, meta_t, mesh=m), n_dev, "sub-tile")
    dj, aj, gj = _jax_render_and_grad(
        lambda vm, m: jfs.render_tracking_depth_subtile(
            vm, jnp.asarray(K), w, h, slot, meta, mesh=m), n_dev)
    assert_close_except_gate_flips(to_np(a), aj, atol=3e-5)
    assert_close_except_gate_flips(to_np(d), dj, atol=3e-4, flip_abs=0.3)
    scale = np.abs(gj[:3]).max()
    np.testing.assert_allclose(to_np(g)[:3], gj[:3], rtol=0,
                               atol=2e-5 * scale)


def test_dryrun_multichip_subtile_step():
    """Two sub-tile steps (kcover=0) in 4 bands: the pose within 1e-6 of
    one device's, within the sub-tile tracking parity test's 5e-5 of the
    JAX package's."""
    h, w = 64, 128
    sj, st = _scene(seed=8)
    single, banded, rj = _steps(
        st, sj, _K(h, w), w, h,
        dict(max_steps=2, patience=10, warmup_steps=0, resort_every=100,
             kcover=0))
    _check_steps(single, banded, rj, 2, 1e-6, 5e-5)


# ---------------------------------------------------------------------------
# the K-cover path (K3 or K4a + K8 per band at the selection, K1 / K2 per
# band at every step)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_cover", [16, 12])
def test_sharded_kcover_build_render_and_grads(k_cover):
    """The pixel-banded cover buffer (K=16: the records select per band;
    K=12: K4a + the index select + the row gather per band) is the
    single-device buffer cut at the band boundaries, bit for bit; its band
    renders (K1 at each band's row0_px) are bit-equal to one device's. The
    port's bands render the JAX package's sharded buffer within the
    K-cover parity test's bounds of the JAX package's sharded render
    (alpha 1e-5, depth 1e-4; gradient 1e-4 of its largest partial)."""
    n_dev = 4
    h, w = 16 * n_dev, 128
    sj, _ = _scene(seed=7)
    K = _K(h, w)
    slot, meta, _ = jfs.build_subtile_slot_buffer(sj, jnp.eye(4),
                                                  jnp.asarray(K), w, h,
                                                  NEAR, FAR)
    slot_t, meta_t = tt(slot), tt(meta, torch.int32)
    n_ty, n_tx = h // 16, 1
    cam = tft.cam_vector(torch.eye(4), tt(K), w, h)
    kb1 = tkc.build_kcover_buffer(slot_t, meta_t, cam, n_ty, n_tx, NEAR, FAR,
                                  k_cover=k_cover)
    kb2 = tkc.build_kcover_buffer(slot_t, meta_t, cam, n_ty, n_tx, NEAR, FAR,
                                  k_cover=k_cover, mesh=_mesh(n_dev))
    assert len(kb2) == n_dev
    assert torch.equal(torch.cat(kb2, dim=2), kb1)

    def render(kb):
        return lambda vm, m: tkc.render_tracking_depth_kcover(
            vm, tt(K), w, h, kb if m is None else kb2, mesh=m)

    _render_and_grads(render(kb1), n_dev, f"K-cover {k_cover}")

    cam_j = jft.cam_vector(jnp.eye(4), jnp.asarray(K), w, h)
    kb_j = jkc.build_kcover_buffer(slot, meta, cam_j, n_ty, n_tx, NEAR, FAR,
                                   k_cover=k_cover, mesh=j_mesh(n_dev))
    bands_j = list(torch.chunk(tt(kb_j), n_dev, dim=2))
    mesh = _mesh(n_dev)
    vm = torch.eye(4).requires_grad_(True)
    d, a = tkc.render_tracking_depth_kcover(vm, tt(K), w, h, bands_j,
                                            mesh=mesh)
    target = d.detach()
    loss = torch.mean((d - target * 1.01) ** 2) + 0.05 * torch.mean(a)
    g = torch.autograd.grad(loss, vm)[0]

    def loss_j(vmx):
        dj, aj = jkc.render_tracking_depth_kcover(vmx, jnp.asarray(K), w, h,
                                                  kb_j, mesh=j_mesh(n_dev))
        return (jnp.mean((dj - jnp.asarray(to_np(target)) * 1.01) ** 2)
                + 0.05 * jnp.mean(aj)), (dj, aj)

    gj, (dj, aj) = jax.jit(jax.grad(loss_j, has_aux=True))(jnp.eye(4))
    np.testing.assert_allclose(to_np(a), np.asarray(aj), atol=1e-5)
    np.testing.assert_allclose(to_np(d), np.asarray(dj), atol=1e-4)
    assert_rel(g[:3], np.asarray(gj)[:3], 1e-4, "viewmat grad")


@pytest.mark.parametrize("k_cover", [16, 12])
def test_dryrun_multichip_kcover_step(k_cover):
    """Four K-cover steps with a re-selection (resort_every 3) in 4 bands:
    equal gate decisions, the pose within 1e-6 of one device's and within
    the K-cover tracking parity test's 1e-4 of the JAX package's."""
    h, w = 64, 128
    sj, st = _scene(seed=8)
    single, banded, rj = _steps(
        st, sj, _K(h, w), w, h,
        dict(max_steps=4, patience=10, warmup_steps=0, resort_every=3,
             kcover=k_cover))
    _check_steps(single, banded, rj, 4, 1e-6, 1e-4)


def test_kcover_step_plain_at_a_band_row_matches_reference():
    """K1/K2's plain forms at a band's first pixel row (the last band of
    4, row0_px 48) against the JAX package's K-cover render at the same
    row0_px: the forward against render_kcover_ref within the K-cover
    parity tests' bounds (alpha 1e-6, depth accumulation 1e-5) and
    bit-equal to the same rows of the whole image's render; the 12 pose
    scalars of _kcover_step_bwd_plain against the JAX package's d_cam of
    the same cotangents (its custom VJP of render_kcover_ref) within 1e-4
    of the largest, as test_torch_kcover.py holds the whole image."""
    h, w = 64, 128
    sj, _ = _scene(seed=7)
    K = _K(h, w)
    slot, meta, _ = jfs.build_subtile_slot_buffer(sj, jnp.eye(4),
                                                  jnp.asarray(K), w, h,
                                                  NEAR, FAR)
    cam_j = jft.cam_vector(jnp.eye(4), jnp.asarray(K), w, h)
    kb = np.asarray(jkc.build_kcover_buffer(slot, meta, cam_j, 4, 1, NEAR,
                                            FAR, k_cover=16))
    m_band = kb.shape[2] // 4
    band = np.ascontiguousarray(kb[:, :, 3 * m_band:])
    row0 = 48.0
    c2w = _near_c2w()
    cam2_j = jft.cam_vector(j_invert(jnp.asarray(c2w)), jnp.asarray(K), w, h)
    cam2 = tt(cam2_j)

    fwd = tkc._kcover_step_fwd_plain(tt(band), cam2, 1, 1, NEAR, FAR, row0)
    whole = tkc._kcover_step_fwd_plain(tt(kb), cam2, 4, 1, NEAR, FAR)
    assert torch.equal(fwd, whole[:, 3 * m_band:])
    d_j, a_j = jkc.render_kcover_ref(jnp.asarray(band), cam2_j, 1, 1, NEAR,
                                     FAR, row0_px=row0)
    d_t = tfs.unscramble_image(fwd[0], 1, 1)
    a_t = tfs.unscramble_image(fwd[1], 1, 1)
    assert float(a_t.mean()) > 0.1
    np.testing.assert_allclose(to_np(a_t), np.asarray(a_j), atol=1e-6)
    np.testing.assert_allclose(to_np(d_t), np.asarray(d_j), atol=1e-5)
    # at row 0 the band would render other pixels: the offset matters
    assert not torch.equal(
        tkc._kcover_step_fwd_plain(tt(band), cam2, 1, 1, NEAR, FAR), fwd)

    rng = np.random.default_rng(3)
    gd = rng.standard_normal((16, 128)).astype(np.float32)
    ga = rng.standard_normal((16, 128)).astype(np.float32)
    d12 = tkc._kcover_step_bwd_plain(
        tt(band), cam2, 1, 1, NEAR, FAR,
        tfs.scramble_image(tt(gd), 1, 1), tfs.scramble_image(tt(ga), 1, 1),
        fwd, row0)

    def f(c):
        dj, aj = jkc.render_kcover(jnp.asarray(band), c, 1, 1, NEAR, FAR,
                                   row0_px=row0, impl="xla")
        return jnp.sum(dj * gd) + jnp.sum(aj * ga)

    g_j = np.asarray(jax.jit(jax.grad(f))(cam2_j))
    assert float(np.abs(g_j[4:16]).max()) > 0
    assert_rel(d12, g_j[4:16], 1e-4, "d_cam")


def _near_c2w():
    from scipy.spatial.transform import Rotation

    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = Rotation.from_euler("xyz", [0.3, -0.2, 0.25],
                                      degrees=True).as_matrix()
    c2w[:3, 3] = [0.004, -0.003, 0.005]
    return c2w


# ---------------------------------------------------------------------------
# the mesh itself, and several processes
# ---------------------------------------------------------------------------

def test_make_tile_mesh_without_a_card_raises():
    """make_tile_mesh() and global_tile_mesh() list the CUDA devices and
    never fall back to the CPU; an explicit list is taken as it is."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default mesh works")
    for fn in (make_tile_mesh, global_tile_mesh):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    mesh = make_tile_mesh(devices=["cpu"] * 3)
    assert mesh.shape["tiles"] == 3 and mesh.device == torch.device("cpu")


@pytest.mark.parametrize("name", ["other_device", "not_a_mesh"])
def test_a_mesh_the_entry_points_cannot_take_raises(name):
    """optimize_pose keeps the image, the loss and Adam on `device`: a mesh
    whose first device is another raises, and so does what is not a
    TileMesh."""
    h, w = 32, 128
    _, st = _scene(n=50)
    mesh, exc = {"other_device": (TileMesh(["meta"]), ValueError),
                 "not_a_mesh": (object(), TypeError)}[name]
    with pytest.raises(exc):
        optimize_pose(st, np.eye(4, dtype=np.float32),
                      np.ones((h, w), np.float32), _K(h, w), w, h,
                      config=TrackingConfig(max_steps=1), device="cpu",
                      mesh=mesh)


def test_distributed_single_process_bootstrap():
    """initialize() with one process sets up nothing (twice); the global
    mesh is then the local one; shard_scenes splits rooms [i::P]."""
    import torch.distributed as dist

    assert initialize("127.0.0.1:1", num_processes=1, process_id=0) is False
    assert initialize("127.0.0.1:1", num_processes=1, process_id=0) is False
    assert not dist.is_initialized()
    mesh = global_tile_mesh(["cpu", "cpu"])
    assert mesh.group is None and mesh.shape["tiles"] == 2
    rooms = [f"room{i}" for i in range(8)]
    assert shard_scenes(rooms) == rooms  # P = 1 takes everything
    parts = [shard_scenes(rooms, process_id=p, process_count=3)
             for p in range(3)]
    assert sorted(sum(parts, [])) == sorted(rooms)
    assert max(map(len, parts)) - min(map(len, parts)) <= 1
    assert parts[1] == rooms[1::3]


# the two-process case: each rank owns 2 CPU bands of a 4-band mesh; the
# same code runs the 4 bands in one process for the comparison
_DIST_CASE = '''
import numpy as np, torch
torch.set_num_threads(1)
from gsplatloc_tpu_torch.data.synthetic import random_gaussian_cloud
from gsplatloc_tpu_torch.models.gaussians import scene_from_point_cloud
from gsplatloc_tpu_torch.ops import fused_tracking as ft
from gsplatloc_tpu_torch.opt.tracking import TrackingConfig, optimize_pose


def run(mesh):
    h, w = 64, 128
    rng = np.random.default_rng(0)
    pts, rgb = random_gaussian_cloud(rng, 400)
    scene = scene_from_point_cloud(torch.as_tensor(pts), torch.as_tensor(rgb),
                                   knn_method="grid", device="cpu")
    scene = scene._replace(scales=torch.full_like(scene.scales, 0.05))
    K = torch.tensor([[60.0, 0, w / 2 - 0.5], [0, 60.0, h / 2 - 0.5],
                      [0, 0, 1]])
    slot, meta, _ = ft.build_slot_buffer(scene, torch.eye(4), K, w, h,
                                         1e-2, 1e10)
    depth_gt, _ = ft.render_tracking_depth(torch.eye(4), K, w, h, slot, meta)
    cfg = TrackingConfig(max_steps=2, patience=10, warmup_steps=0,
                         resort_every=100, kcover=0, subtile=False)
    res = optimize_pose(scene, torch.eye(4), depth_gt * 1.01, K, w, h,
                        config=cfg, backend="fused", device="cpu", mesh=mesh)
    return dict(steps_run=res.steps_run,
                trans=[float(v).hex() for v in res.final_pose.trans],
                quat=[float(v).hex() for v in res.final_pose.quat],
                best_loss=float(res.best_loss).hex())
'''

_DIST_CHILD = _DIST_CASE + '''
import json, sys
from gsplatloc_tpu_torch.parallel import global_tile_mesh, initialize, shard_scenes
rank, port = int(sys.argv[1]), int(sys.argv[2])
assert initialize(f"127.0.0.1:{port}", num_processes=2, process_id=rank)
mesh = global_tile_mesh(["cpu", "cpu"])
assert mesh.shape["tiles"] == 4 and mesh.band0 == 2 * rank
out = run(mesh)
out["rooms"] = shard_scenes([f"room{i}" for i in range(5)])
print("RESULT " + json.dumps(out), flush=True)
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_distributed_two_process_cpu():
    """Two OS processes in one gloo group, each owning 2 of 4 CPU bands, run
    two full-tile steps: both ranks' poses and losses are bit-equal to each
    other and to one process running the same 4 bands; shard_scenes gives
    the ranks disjoint halves of 5 rooms."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DIST_CHILD, str(rank), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT)) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = [json.loads(next(line for line in o.splitlines()
                               if line.startswith("RESULT "))[7:])
               for o in outs]
    scope = {}
    exec(_DIST_CASE, scope)
    single = scope["run"](_mesh(4))
    for r in results:
        assert {k: r[k] for k in single} == single
    assert single["steps_run"] == 2
    assert any(float.fromhex(v) != 0.0 for v in single["trans"])
    assert results[0]["rooms"] == ["room0", "room2", "room4"]
    assert results[1]["rooms"] == ["room1", "room3"]


def test_cli_track_host_shard_in_one_process(tmp_path, monkeypatch):
    """`cli track --host-shard` in one process (no process group): every
    room is tracked, and res.json equals the run without the flag; with a
    stand-in group of 2 (shard_scenes' defaults), rank 1 takes rooms[1::2]."""
    from gsplatloc_tpu_torch import cli

    argv = ["track", "--device", "cpu", "--dataset", "Synthetic", "--frames",
            "2", "--height", "32", "--width", "48", "--num-iters", "10",
            "--knn", "grid", "--quiet"]
    res = {}
    for flag in ([], ["--host-shard"]):
        out = tmp_path / ("shard" if flag else "plain")
        cli.main(argv + flag + ["--run-dir", str(out)])
        res[bool(flag)] = json.loads((out / "res.json").read_text())
    assert res[True] == res[False]
    assert list(res[True]["Synthetic"]) == ["synthetic"]

    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    assert shard_scenes(["room0", "room1", "room2"]) == ["room1"]
