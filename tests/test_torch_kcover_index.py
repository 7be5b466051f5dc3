"""Port vs reference: the index select (select_kcover) and the K-cover path
at every K (build_kcover_buffer's routing on K * NREC_KC % 8, as the JAX
package routes it).

On the CPU the port's wrappers take their plain PyTorch versions; the
reference's Pallas select kernels run in interpret mode, as the
reference's own tests run them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplatloc_tpu.losses import tracking_loss as j_tracking_loss
from gsplatloc_tpu.ops import kcover as jkc
from gsplatloc_tpu.ops.fused_subtile import _project8_pallas as j_project8
from gsplatloc_tpu.ops.fused_subtile import (
    build_subtile_slot_buffer, render_tracking_depth_subtile,
)
from gsplatloc_tpu.ops.fused_tracking import cam_vector as j_cam_vector
from gsplatloc_tpu.ops.lie import invert_se3
from gsplatloc_tpu.opt.tracking import TrackingConfig as JConfig
from gsplatloc_tpu.opt.tracking import optimize_pose as j_optimize_pose
from gsplatloc_tpu_torch import kernels
from gsplatloc_tpu_torch.convert import config_from_reference
from gsplatloc_tpu_torch.losses import tracking_loss as t_tracking_loss
from gsplatloc_tpu_torch.ops import kcover as tkc
from gsplatloc_tpu_torch.ops.fused_tracking import cam_vector as t_cam_vector
from gsplatloc_tpu_torch.opt.tracking import optimize_pose
from torch_port_helpers import box_scene, perturbed_c2w, to_np, tt

H, W = 64, 128
N_TY, N_TX = -(-H // 16), -(-W // 128)
M_OUT = N_TY * N_TX * 8 * 256
NEAR, FAR = 1e-2, 1e10


@pytest.fixture(scope="module")
def ctx():
    """The K-cover slot buffer (built by the reference at the identity pose,
    handed over as numpy) and its projected rows (the reference's
    interpreted projection kernel)."""
    scene_j, _scene_t, K = box_scene(H, W)
    vm = np.eye(4, dtype=np.float32)
    slot_j, meta_j, _ = jkc.build_kcover_slot_buffer(
        scene_j, jnp.asarray(vm), jnp.asarray(K), W, H, NEAR, FAR)
    cam_j = j_cam_vector(jnp.asarray(vm), jnp.asarray(K), W, H)
    p8_j = j_project8(slot_j, cam_j, NEAR, FAR)
    return dict(slot_j=slot_j, meta_j=meta_j, cam_j=cam_j, p8_j=p8_j,
                slot=tt(slot_j),
                meta=tt(meta_j, torch.int32), p8=tt(p8_j),
                cam=t_cam_vector(tt(vm), tt(K), W, H))


@pytest.mark.parametrize("k_cover", [8, 12])
def test_index_select_live_columns_equal_reference(ctx, k_cover):
    """The reference's select gates liveness per 256-slot block and may
    hold a post-death column in the tail of a K-list where the port, exact
    per pixel, holds the dummy (H3). Every column the port admits equals
    the reference's at the same (k, pixel); every dummy is M_pad in both;
    the reference holds no dummy where the port holds a column."""
    idx_j = to_np(jkc.select_kcover(ctx["p8_j"], ctx["meta_j"], N_TY, N_TX,
                                    k_cover))
    idx_t = to_np(tkc._select_index_plain(ctx["p8"], ctx["meta"], N_TY,
                                          N_TX, k_cover))
    m_pad = ctx["p8"].shape[1]
    assert idx_t.shape == idx_j.shape == (k_cover, M_OUT)
    assert idx_t.dtype == np.float32
    live = idx_t != m_pad
    assert live.mean() > 0.1
    np.testing.assert_array_equal(idx_t[live], idx_j[live])
    # columns are integers inside the buffer; the dummy is one past it
    for idx in (idx_t, idx_j):
        assert (idx == np.round(idx)).all()
        assert ((idx >= 0) & (idx <= m_pad)).all()
    # lists are prefix-packed: no dummy before a column
    assert (np.diff(live.astype(np.int8), axis=0) <= 0).all()


@pytest.mark.parametrize("k_cover", [8, 12, 16])
def test_gather_route_equals_records_select(ctx, k_cover):
    """The index route (project8 -> select_kcover -> row gather) builds the
    records select's buffer exactly, at every K: both walk alike. (At K=12
    via="records" takes the index route as well, as in the reference, so
    the records select is also called directly.)"""
    args = (ctx["slot"], ctx["meta"], ctx["cam"], N_TY, N_TX, NEAR, FAR)
    kb_g = tkc.build_kcover_buffer(*args, k_cover=k_cover, via="gather")
    kb_r = tkc.build_kcover_buffer(*args, k_cover=k_cover, via="records")
    direct = tkc.select_kcover_records(ctx["slot"], ctx["meta"], ctx["cam"],
                                       N_TY, N_TX, k_cover, NEAR, FAR)
    assert tuple(kb_g.shape) == (tkc.NREC_KC, k_cover, M_OUT)
    assert float(kb_g[4].gt(0).float().mean()) > 0.1
    np.testing.assert_allclose(to_np(kb_g), to_np(direct), rtol=0, atol=0)
    np.testing.assert_allclose(to_np(kb_r), to_np(direct), rtol=0, atol=0)


@pytest.mark.parametrize("k_cover,route", [(12, "index"), (4, "index"),
                                           (16, "records"), (8, "records")])
def test_build_kcover_buffer_routes_on_k(ctx, monkeypatch, k_cover, route):
    """K * NREC_KC % 8 != 0 (K = 4, 12, ...) takes the index select, as in
    the reference (gsplatloc_tpu/ops/kcover.py, build_kcover_buffer); an
    aligned K takes the records select."""
    calls = []
    for name in ("select_kcover", "select_kcover_records"):
        fn = getattr(tkc, name)
        monkeypatch.setattr(
            tkc, name,
            lambda *a, _fn=fn, _name=name, **k: (calls.append(_name),
                                                 _fn(*a, **k))[1])
    tkc.build_kcover_buffer(ctx["slot"], ctx["meta"], ctx["cam"], N_TY, N_TX,
                            NEAR, FAR, k_cover=k_cover)
    assert calls == (["select_kcover"] if route == "index"
                     else ["select_kcover_records"])


def test_kcover_buffer_at_k12_renders_like_reference(ctx):
    """The K=12 cover buffers of both packages (both through their index
    route) render alike to within T_EPS (the reference's post-death tail
    weighs <= T_EPS in total)."""
    kb_j = jkc.build_kcover_buffer(ctx["slot_j"], ctx["meta_j"], ctx["cam_j"],
                                   N_TY, N_TX, NEAR, FAR, k_cover=12)
    kb_t = tkc.build_kcover_buffer(ctx["slot"], ctx["meta"], ctx["cam"],
                                   N_TY, N_TX, NEAR, FAR, k_cover=12)
    d_j, a_j = tkc.render_kcover_ref(tt(kb_j), ctx["cam"], N_TY, N_TX,
                                     NEAR, FAR)
    d_t, a_t = tkc.render_kcover_ref(kb_t, ctx["cam"], N_TY, N_TX, NEAR, FAR)
    np.testing.assert_allclose(to_np(a_t), to_np(a_j), atol=1e-5)
    np.testing.assert_allclose(to_np(d_t), to_np(d_j), atol=1e-4)


def test_index_select_raises_where_f32_columns_stop_being_exact():
    """M_pad + 1 columns (with the dummy) above 2**24 cannot all be exact
    f32 values: the wrapper refuses before it reads anything (an expanded
    view, so no memory is touched)."""
    meta = torch.zeros((N_TY * N_TX * 8 + 2,), dtype=torch.int32)
    big = torch.zeros((8, 1)).expand(8, 2 ** 24)
    with pytest.raises(ValueError, match="2\\*\\*24"):
        tkc.select_kcover(big, meta, N_TY, N_TX, 12)
    # the largest buffer it takes
    ok = torch.zeros((8, 1)).expand(8, 2 ** 24 - 1)
    meta_ok = torch.zeros_like(meta)
    out = tkc.select_kcover(ok, meta_ok, N_TY, N_TX, 4)
    assert float(out.min()) == float(out.max()) == 2 ** 24 - 1


def test_index_select_uncovered_pixels_hold_the_dummy():
    slot = torch.zeros((8, 8192))
    meta = torch.zeros((N_TY * N_TX * 8 + 2,), dtype=torch.int32)
    cam = t_cam_vector(torch.eye(4), tt(np.eye(3)), W, H)
    idx = tkc.select_kcover(tkc.project8(slot, cam, NEAR, FAR), meta, N_TY,
                            N_TX, 12)
    assert tuple(idx.shape) == (12, M_OUT)
    assert bool((idx == 8192.0).all())
    kb = tkc.build_kcover_buffer(slot, meta, cam, N_TY, N_TX, NEAR, FAR,
                                 k_cover=12)
    assert float(kb.abs().max()) == 0.0


def test_optimize_pose_kcover12_matches_reference():
    """The whole K-cover loop at K=12 (the index route at every
    re-selection in both packages), on the pair and with the settings of
    tests/test_torch_tracking.py::test_optimize_pose_matches_reference:
    equal steps_run, rebuilds and selects, best and final pose within
    1e-4, no launch on the CPU. The loss is compared where both packages
    see the same cover buffer: at the reference's best pose, one K=12
    buffer built by each package from the same slot buffer, rendered and
    scored by each, within 1e-5 (measured 1.8e-6). (The best losses of the two runs are not compared: at
    K=12 the cover lists of this scene truncate at some pixels, so a
    re-selection a hair away re-picks a truncated list and moves the mean
    loss by percents; the port alone, started 1e-6 away, lands 12 % apart
    in best loss.)"""
    h = 48
    scene_j, scene_t, K = box_scene(h, W, clutter=10)
    gt = perturbed_c2w((0.7, -0.4, 0.3), (0.012, -0.01, 0.018))
    vm = invert_se3(jnp.asarray(gt))
    slot, meta, _ = build_subtile_slot_buffer(scene_j, vm, jnp.asarray(K),
                                              W, h, NEAR, FAR)
    depth_gt, _ = render_tracking_depth_subtile(vm, jnp.asarray(K), W, h,
                                                slot, meta)
    depth_gt = np.asarray(jax.lax.stop_gradient(depth_gt))
    cfg_j = JConfig(max_steps=60, patience=50, warmup_steps=10,
                    resort_every=10, kcover=12)
    rj = j_optimize_pose(scene_j, jnp.eye(4), jnp.asarray(depth_gt),
                         jnp.asarray(K), W, h, config=cfg_j, backend="fused")
    kernels.reset_launch_counts()
    rt = optimize_pose(scene_t, np.eye(4, dtype=np.float32), depth_gt, K, W,
                       h, config=config_from_reference(cfg_j),
                       backend="fused", device="cpu")
    assert all(v == 0 for v in kernels.launch_counts().values())
    assert rt.steps_run == int(rj.steps_run) == 60
    assert rt.rebuilds == int(rj.rebuilds)
    assert rt.selects == int(rj.selects) >= 1
    assert rt.slot_overflow == bool(rj.slot_overflow) is False
    for f in ("best_pose", "final_pose"):
        np.testing.assert_allclose(to_np(getattr(rt, f).quat),
                                   to_np(getattr(rj, f).quat), atol=1e-4)
        np.testing.assert_allclose(to_np(getattr(rt, f).trans),
                                   to_np(getattr(rj, f).trans), atol=1e-4)
    vm_b = invert_se3(rj.best_pose.to_c2w())
    slot_b, meta_b, _ = jkc.build_kcover_slot_buffer(
        scene_j, vm_b, jnp.asarray(K), W, h, NEAR, FAR)
    kb_j = jkc.build_kcover_buffer(
        slot_b, meta_b, j_cam_vector(vm_b, jnp.asarray(K), W, h),
        -(-h // 16), N_TX, NEAR, FAR, k_cover=12)
    d_j, _ = jkc.render_tracking_depth_kcover(vm_b, jnp.asarray(K), W, h,
                                              kb_j, NEAR, FAR)
    tl_j = j_tracking_loss(d_j, jnp.asarray(depth_gt), cfg_j.depth_lambda,
                           cfg_j.normal_lambda)
    vm_t, K_t = tt(vm_b), tt(K)
    kb_t = tkc.build_kcover_buffer(
        tt(slot_b), tt(meta_b, torch.int32), t_cam_vector(vm_t, K_t, W, h),
        -(-h // 16), N_TX, NEAR, FAR, k_cover=12)
    d_t, _ = tkc.render_tracking_depth_kcover(vm_t, K_t, W, h, kb_t,
                                              NEAR, FAR)
    tl_t = t_tracking_loss(d_t, tt(depth_gt), cfg_j.depth_lambda,
                           cfg_j.normal_lambda)
    for f in ("total", "depth", "silhouette"):
        np.testing.assert_allclose(float(getattr(tl_t, f)),
                                   float(getattr(tl_j, f)), rtol=1e-5)
    e_t0 = float(np.linalg.norm(gt[:3, 3]))
    best = to_np(rt.best_pose.to_c2w()).astype(np.float64)
    assert float(np.linalg.norm(best[:3, 3] - gt[:3, 3])) < e_t0 / 2
