"""The full-tile fused tracking render of the port (ops/fused_tracking.py,
on the CPU through the plain versions of K7a/K7b/K7c) against the JAX
package's, which runs its Pallas kernels in interpret mode: the slot
buffer, the forward, the pose gradient, the probe and the compaction, from
the same numpy-seeded scenes at the reference test's sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gsplatloc_tpu.data import parser as jparser
from gsplatloc_tpu.data.synthetic import box_room_frame, random_gaussian_cloud
from gsplatloc_tpu.models.gaussians import scene_from_point_cloud
from gsplatloc_tpu.ops import camera
from gsplatloc_tpu.ops import fused_tracking as jft
from gsplatloc_tpu_torch import kernels
from gsplatloc_tpu.opt.tracking import TrackingConfig as JConfig
from gsplatloc_tpu.tracking.runner import SequenceRunner as JRunner
from gsplatloc_tpu_torch.convert import config_from_reference, scene_from_numpy
from gsplatloc_tpu_torch.data import parser as tparser
from gsplatloc_tpu_torch.ops import fused_tracking as ft
from gsplatloc_tpu_torch.ops.binning import TILE_H, TILE_W
from gsplatloc_tpu_torch.ops.rasterize import rasterize as t_rasterize
from helpers import assert_close_except_gate_flips
from gsplatloc_tpu_torch.tracking.runner import SequenceRunner
from torch_port_helpers import perturbed_c2w, to_np

NEAR, FAR = 1e-2, 1e10


def _scenes(n, seed=0, scales=0.05, opacity=1.0, mixed=False):
    """The reference test's scene (random cloud, isotropic scales, one
    opacity) in both packages."""
    rng = np.random.default_rng(seed)
    pts, rgb = random_gaussian_cloud(rng, n)
    scene = scene_from_point_cloud(jnp.asarray(pts), jnp.asarray(rgb))
    if mixed:
        s = rng.uniform(0.02, 0.08, (n, 1)).astype(np.float32)
        scene = scene._replace(scales=jnp.asarray(np.repeat(s, 3, axis=1)))
    else:
        scene = scene._replace(scales=jnp.full_like(scene.scales, scales))
    scene = scene._replace(opacities=jnp.full_like(scene.opacities, opacity))
    scene_t = scene_from_numpy(
        {k: np.asarray(getattr(scene, k)) for k in scene._fields},
        device="cpu")
    return scene, scene_t


def _view(angles=(2, -1, 1), t=(0.03, -0.02, 0.05)):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = Rotation.from_euler("xyz", angles, degrees=True).as_matrix()
    c2w[:3, 3] = t
    return np.linalg.inv(c2w).astype(np.float32)


def _K(h, w, f):
    return np.array(camera.intrinsics_matrix(f, f, w / 2 - 0.5, h / 2 - 0.5))


def _build_both(scene_j, scene_t, vm, K, w, h):
    sj, mj, _ = jft.build_slot_buffer(scene_j, jnp.asarray(vm),
                                      jnp.asarray(K), w, h, NEAR, FAR)
    st, mt, _ = ft.build_slot_buffer(scene_t, torch.as_tensor(vm),
                                     torch.as_tensor(K), w, h, NEAR, FAR)
    return (sj, mj), (st, mt)


@pytest.mark.parametrize("mixed", [False, True])
def test_build_slot_buffer_equals_reference(mixed):
    """Projection, stable binning with exact big-splat tiles and the record
    gather: the (8, M_pad) slot buffer and meta equal the reference's
    integer for integer and value for value, padding slots (Gaussian 0's
    record) included."""
    h, w = 48, 160
    scene_j, scene_t = _scenes(500, opacity=0.6, mixed=mixed)
    (sj, mj), (st, mt) = _build_both(scene_j, scene_t, _view(), _K(h, w, 80.0),
                                     w, h)
    np.testing.assert_array_equal(to_np(mt), np.asarray(mj))
    np.testing.assert_array_equal(to_np(st), np.asarray(sj))
    assert st.dtype == torch.float32 and st.is_contiguous()
    assert int(mt[-1]) < st.shape[1]  # the walks never reach the padding


@pytest.mark.parametrize("opacity", [1.0, 0.6])
@pytest.mark.parametrize("mixed", [False, True])
def test_forward_matches_reference_and_general_path(opacity, mixed):
    """Depth and alpha of render_tracking_depth against the reference's at
    the same pose (gate flips allowed as the reference test allows them:
    atol 3e-5 alpha, 3e-4 depth), and against the port's own general
    rasterizer in ED mode from the same scene (the two paths bin the same
    tiles and apply the same gates)."""
    h, w = 48, 160
    scene_j, scene_t = _scenes(500, opacity=opacity, mixed=mixed)
    K, vm = _K(h, w, 80.0), _view()
    (sj, mj), (st, mt) = _build_both(scene_j, scene_t, vm, K, w, h)
    dj, aj = jft.render_tracking_depth(jnp.asarray(vm), jnp.asarray(K), w, h,
                                       sj, mj)
    dt, at = ft.render_tracking_depth(torch.as_tensor(vm), torch.as_tensor(K),
                                      w, h, st, mt)
    assert tuple(dt.shape) == tuple(at.shape) == (h, w)
    assert_close_except_gate_flips(to_np(at), np.asarray(aj), atol=3e-5)
    assert_close_except_gate_flips(to_np(dt), np.asarray(dj), atol=3e-4,
                                   flip_abs=0.3)
    s = scene_t
    r, ag = t_rasterize(s.means, s.quats, s.scales, s.opacities, s.sh_coeffs,
                        torch.as_tensor(vm), torch.as_tensor(K), w, h,
                        sh_degree=1, render_mode="ED", backend="pallas")
    assert_close_except_gate_flips(to_np(at), to_np(ag), atol=3e-5)
    assert_close_except_gate_flips(to_np(dt), to_np(r[..., 0]), atol=3e-4,
                                   flip_abs=0.3)
    assert float(at.mean()) > 0.2


def _grad_case(opacity):
    h, w = 32, 128
    scene_j, scene_t = _scenes(300, seed=4, opacity=opacity, mixed=True)
    K = _K(h, w, 70.0)
    vm0 = _view((1, -0.5, 0.8), (0.01, -0.015, 0.02))
    (sj, mj), (st, mt) = _build_both(scene_j, scene_t, vm0, K, w, h)
    rng = np.random.default_rng(11)
    target = rng.uniform(1.0, 3.0, (h, w)).astype(np.float32)
    return h, w, K, vm0, (sj, mj), (st, mt), target


def _loss_t(vm, K, w, h, st, mt, target):
    d, a = ft.render_tracking_depth(vm, torch.as_tensor(K), w, h, st, mt)
    return torch.mean((d - torch.as_tensor(target)) ** 2) + 0.1 * torch.mean(a)


@pytest.mark.parametrize("opacity", [1.0, 0.55])
def test_pose_grad_matches_reference(opacity):
    """d(loss)/d(viewmat) of a depth + alpha loss through the full-tile
    render against the reference's jax.grad of the same loss (rtol 3e-3,
    atol 3e-4 of the gradient's scale, the reference test's bounds)."""
    h, w, K, vm0, (sj, mj), (st, mt), target = _grad_case(opacity)

    def loss_j(vm):
        d, a = jft.render_tracking_depth(vm, jnp.asarray(K), w, h, sj, mj)
        return jnp.mean((d - target) ** 2) + 0.1 * jnp.mean(a)

    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(vm0)))
    vm = torch.as_tensor(vm0).clone().requires_grad_(True)
    _loss_t(vm, K, w, h, st, mt, target).backward()
    g_t = to_np(vm.grad)
    scale = np.abs(g_j[:3, :]).max()
    assert scale > 0
    np.testing.assert_allclose(g_t[:3, :], g_j[:3, :], rtol=3e-3,
                               atol=3e-4 * scale)
    assert np.all(g_t[3] == 0)


def test_plain_backward_matches_a_float64_replay():
    """The plain backward (the direct-form per-slot sums, the pose chain
    per slot) in float32 against its own float64 replay for seeded
    cotangents, and the reference's backward (tile-local moment expansion)
    against the same replay. The replay also re-rounds the in-kernel
    projection, and the suffix form divides by 1 - alpha down to 1e-3 at
    opacity 1, so the bound is 3e-6 of the largest partial (measured
    1.8e-6); the reference is off by 7.9e-6 there, and the port must stay
    the nearer of the two."""
    h, w, K, vm0, (sj, mj), (st, mt), target = _grad_case(1.0)
    n_ty, n_tx = -(-h // TILE_H), -(-w // TILE_W)
    cam = ft.cam_vector(torch.as_tensor(vm0), torch.as_tensor(K), w, h)
    out, cd = ft.fused_fwd(st, mt, cam, n_ty, n_tx, NEAR, FAR)
    rng = np.random.default_rng(5)
    g = torch.as_tensor(rng.standard_normal((2,) + tuple(out.shape[1:]))
                        .astype(np.float32))
    px_in = torch.cat([out, g])
    d32 = ft.fused_bwd(st, mt, cam, cd, px_in, n_ty, n_tx, NEAR, FAR)
    d64 = ft._fused_bwd_plain(st.double(), mt, cam.double(), cd,
                              px_in.double(), n_ty, n_tx, NEAR, FAR)
    assert d32.dtype == torch.float32 and d64.dtype == torch.float64
    cam_j = jft.cam_vector(jnp.asarray(vm0), jnp.asarray(K), w, h)
    outs = jft._fused_fwd_impl(sj, mj, cam_j, n_ty, n_tx, sj.shape[1], NEAR,
                               FAR)
    _, _, d_cam_j = jft._fused_vjp_bwd(
        n_ty, n_tx, sj.shape[1], NEAR, FAR, (sj, mj, cam_j, outs),
        (jnp.asarray(to_np(g[0])), jnp.asarray(to_np(g[1]))))
    d_j = np.asarray(d_cam_j)[4:16].astype(np.float64)
    scale = float(d64.abs().max())
    assert scale > 0
    err = float((d32.double() - d64).abs().max())
    err_j = float(np.abs(d_j - to_np(d64)).max())
    assert err <= 3e-6 * scale, (err, scale, err / scale)
    assert err < err_j, (err / scale, err_j / scale)


@pytest.mark.parametrize("opacity", [1.0, 0.6])
def test_probe_and_compaction_match_reference_and_are_exact(opacity):
    """The probe marks the same slots as the reference's inside the walked
    coverage (the reference leaves garbage beyond it, the port zero), with
    equal chunks done; the compacted buffer and offsets equal the
    reference's over the kept prefix; at the probe pose the compacted
    render equals the uncompacted one bit for bit (dropping a slot that is
    alpha-0 or behind a dead transmittance at every pixel is an exact
    no-op of the sequential recurrence), and the pose gradient agrees
    within 1e-6 of its scale (only the order of the per-slot sum moves)."""
    h, w = 48, 160
    scene_j, scene_t = _scenes(800, seed=3, opacity=opacity, mixed=True)
    K, vm = _K(h, w, 80.0), _view()
    (sj, mj), (st, mt) = _build_both(scene_j, scene_t, vm, K, w, h)
    n_ty, n_tx = -(-h // TILE_H), -(-w // TILE_W)
    m_pad = st.shape[1]
    cj, cdj = jft.fused_probe(sj, mj, jft.cam_vector(jnp.asarray(vm),
                                                     jnp.asarray(K), w, h),
                              n_ty, n_tx, m_pad, NEAR, FAR)
    cam = ft.cam_vector(torch.as_tensor(vm), torch.as_tensor(K), w, h)
    ct, cdt = ft.fused_probe(st, mt, cam, n_ty, n_tx, NEAR, FAR)
    np.testing.assert_array_equal(to_np(cdt), np.asarray(cdj))
    starts = to_np(mt)[1:]
    covered = np.zeros(m_pad, bool)
    for t in range(n_ty * n_tx):
        cov_end = (starts[t] // 128) * 128 + int(cdt[t]) * 128
        covered[starts[t]:min(starts[t + 1], cov_end)] = True
    np.testing.assert_array_equal(to_np(ct)[covered], np.asarray(cj)[covered])
    assert np.all(to_np(ct)[~covered] == 0)

    sc, mc = ft.compact_slot_buffer(st, mt, ct, cdt)
    scj, mcj = jft.compact_slot_buffer(sj, mj, cj, cdj)
    np.testing.assert_array_equal(to_np(mc), np.asarray(mcj))
    kept, total = int(mc[-1] - mc[1]), int(mt[-1] - mt[1])
    assert 0 < kept < total, (kept, total)
    np.testing.assert_array_equal(to_np(sc)[:, :kept],
                                  np.asarray(scj)[:, :kept])

    vmt, Kt = torch.as_tensor(vm), torch.as_tensor(K)
    d_full, a_full = ft.render_tracking_depth(vmt, Kt, w, h, st, mt)
    d_c, a_c = ft.render_tracking_depth(vmt, Kt, w, h, sc, mc)
    assert torch.equal(d_c, d_full) and torch.equal(a_c, a_full)

    rng = np.random.default_rng(11)
    wd = torch.as_tensor(rng.standard_normal((h, w)).astype(np.float32))
    wa = torch.as_tensor(rng.standard_normal((h, w)).astype(np.float32))

    def grad(slot, meta):
        v = vmt.clone().requires_grad_(True)
        d, a = ft.render_tracking_depth(v, Kt, w, h, slot, meta)
        (torch.mean(d * wd) + torch.mean(a * wa)).backward()
        return to_np(v.grad)

    g_full, g_c = grad(st, mt), grad(sc, mc)
    scale = max(np.abs(g_full).max(), 1e-12)
    np.testing.assert_allclose(g_c, g_full, rtol=0, atol=1e-6 * scale)


def test_cpu_path_launches_no_kernel_and_builds_nothing():
    """Build, probe, compaction, render and its backward on CPU tensors:
    the wrappers take their plain versions, count no launch and build no
    library; the wrappers' outputs keep the kernels' shapes and types."""
    kernels.reset_launch_counts()
    h, w = 32, 128
    _, scene_t = _scenes(200, seed=1)
    K, vm = torch.as_tensor(_K(h, w, 70.0)), torch.as_tensor(_view())
    slot, meta, _ = ft.build_slot_buffer(scene_t, vm, K, w, h, NEAR, FAR)
    cam = ft.cam_vector(vm, K, w, h)
    contrib, cd = ft.fused_probe(slot, meta, cam, 2, 1, NEAR, FAR)
    assert contrib.shape == (slot.shape[1],) and cd.dtype == torch.int32
    slot, meta = ft.compact_slot_buffer(slot, meta, contrib, cd)
    v = vm.clone().requires_grad_(True)
    d, a = ft.render_tracking_depth(v, K, w, h, slot, meta)
    (d.sum() + a.sum()).backward()
    assert float(v.grad.abs().max()) > 0
    out, cd = ft.fused_fwd(slot, meta, cam, 2, 1, NEAR, FAR)
    assert tuple(out.shape) == (2, 32, 128) and out.dtype == torch.float32
    assert all(v == 0 for v in kernels.launch_counts().values())
    assert kernels._lib is None


def test_render_depth_gt_fused_matches_reference():
    """The depth target through the full-tile render (opacity-1 kNN-scaled
    splats of a box-room frame, exact big-splat binning, near 1e-2, far
    1e10): within 1e-4 of the reference's on covered pixels, zero on the
    same pixels."""
    h, w = 16, 48
    K = np.array([[24.0, 0, w / 2 - 0.5], [0, 24.0, h / 2 - 0.5], [0, 0, 1]],
                 np.float32)
    c2w = perturbed_c2w((1.0, 0.5, -0.5), (0.05, 0.02, -0.03))
    rgb, depth = box_room_frame(np.eye(4), K, h, w)
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    pts = np.stack([(u - K[0, 2]) / K[0, 0] * depth,
                    (v - K[1, 2]) / K[1, 1] * depth, depth],
                   axis=-1).reshape(-1, 3).astype(np.float32)
    cols = rgb.reshape(-1, 3).astype(np.float32)
    d_j = np.asarray(jparser.render_depth_gt(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(K), jnp.asarray(c2w),
        h, w, grid_shape=(h, w), backend="fused"))
    d_t = to_np(tparser.render_depth_gt(pts, cols, K, c2w, h, w,
                                        grid_shape=(h, w), backend="fused",
                                        device="cpu"))
    assert d_t.shape == (h, w)
    np.testing.assert_array_equal(d_t == 0, d_j == 0)
    np.testing.assert_allclose(d_t, d_j, atol=1e-4)
    assert (d_j > 0).mean() > 0.9


def test_runner_fulltile_matches_reference_runner(tmp_path):
    """Both runners with TrackingConfig(subtile=False) (and the default
    kcover=16, which does not apply there) on the same Synthetic pair with
    grid kNN: the parser renders the depth target through the full-tile
    render ("fused") in both, the pair's target depths agree within 1e-4,
    and the tracked pair gives equal steps, eT within 1e-4 m and eR within
    0.02 deg (the runner test's bounds for the other fused paths)."""
    cfg = JConfig(max_steps=30, patience=20, warmup_steps=5,
                  resort_every=10, subtile=False)
    kw = dict(data_set="Synthetic", scene_name="", normalize=True,
              backend="fused", height=32, width=48, speed=8.0, max_pairs=1,
              n_frames=2, knn_method="grid")
    jr = JRunner(config=cfg, run_dir=tmp_path / "j", **kw)
    tr = SequenceRunner(config=config_from_reference(cfg),
                        run_dir=tmp_path / "t", device="cpu", **kw)
    assert jr.parser.backend == tr.parser.backend == "fused"
    np.testing.assert_allclose(to_np(tr.parser[0].src_depth),
                               np.asarray(jr.parser[0].src_depth), atol=1e-4)
    rj, rt = jr.train(progress=False), tr.train(progress=False)
    assert rt.steps == [int(s) for s in rj.steps] == [30]
    np.testing.assert_allclose(rt.eT, rj.eT, rtol=0, atol=1e-4)
    np.testing.assert_allclose(rt.eR, rj.eR, rtol=0, atol=0.02)
