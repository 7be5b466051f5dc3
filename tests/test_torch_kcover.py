"""Port vs reference: the K-cover renderer (slot buffer, records select,
step render forward and hand-written backward; the index select and the
routing on K are in test_torch_kcover_index.py).

On the CPU the port's wrappers take their plain PyTorch versions; the
reference's Pallas kernels run in interpret mode (as the reference's own
tests run them) and its plain-XLA forms serve as oracles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplatloc_tpu.ops import kcover as jkc
from gsplatloc_tpu.ops.fused_tracking import cam_vector as j_cam_vector
from gsplatloc_tpu.ops.lie import invert_se3 as j_invert
from gsplatloc_tpu_torch.models.pose import PoseState as TPose
from gsplatloc_tpu_torch.ops import kcover as tkc
from gsplatloc_tpu_torch.ops.fused_tracking import cam_vector as t_cam_vector
from gsplatloc_tpu_torch.ops.lie import invert_se3 as t_invert
from torch_port_helpers import (
    assert_rel, box_scene, perturbed_c2w, to_np, tt,
)

H, W = 64, 128
N_TY, N_TX = -(-H // 16), -(-W // 128)
NEAR, FAR = 1e-2, 1e10
K_COVER = 16


@pytest.fixture(scope="module")
def ctx():
    """Scene, slot buffer (built by the reference, handed over as numpy) and the
    cover buffers of both packages at the identity pose."""
    scene_j, scene_t, K = box_scene(H, W)
    vm = np.eye(4, dtype=np.float32)
    slot_j, meta_j, ovf_j = jkc.build_kcover_slot_buffer(
        scene_j, jnp.asarray(vm), jnp.asarray(K), W, H, NEAR, FAR)
    cam_j = j_cam_vector(jnp.asarray(vm), jnp.asarray(K), W, H)
    kb_j = jkc.build_kcover_buffer(slot_j, meta_j, cam_j, N_TY, N_TX,
                                   NEAR, FAR, k_cover=K_COVER)
    slot_t, meta_t = tt(slot_j), tt(meta_j, torch.int32)
    cam_t = t_cam_vector(tt(vm), tt(K), W, H)
    kb_t = tkc.build_kcover_buffer(slot_t, meta_t, cam_t, N_TY, N_TX,
                                   NEAR, FAR, k_cover=K_COVER)
    # a pose about a pixel off the selection pose: every gradient path live
    c2w = perturbed_c2w()
    return dict(scene_j=scene_j, scene_t=scene_t, K=K, vm=vm,
                slot_j=slot_j, meta_j=meta_j, ovf_j=ovf_j, cam_j=cam_j,
                cam_t=cam_t, kb_j=kb_j, kb_t=kb_t, c2w=c2w,
                cam2_j=j_cam_vector(j_invert(jnp.asarray(c2w)),
                                    jnp.asarray(K), W, H),
                cam2_t=t_cam_vector(t_invert(tt(c2w)), tt(K), W, H))


# ---------------------------------------------------------------- rebuild

@pytest.mark.parametrize("budget", [1.0, 0.7])
def test_slot_buffer_equals_reference(ctx, budget):
    """Same scene, same pose -> the SAME slot buffer, bit for bit (both
    sides sort stably on the same packed key; at the identity pose the
    camera transform is exact, so no depth key differs by an ulp)."""
    sj, mj, oj = jkc.build_kcover_slot_buffer(
        ctx["scene_j"], jnp.asarray(ctx["vm"]), jnp.asarray(ctx["K"]), W, H,
        NEAR, FAR, slot_budget=budget)
    st, mt, ot = tkc.build_kcover_slot_buffer(
        ctx["scene_t"], tt(ctx["vm"]), tt(ctx["K"]), W, H, NEAR, FAR,
        slot_budget=budget)
    assert tuple(st.shape) == tuple(sj.shape) and st.shape[0] == 8
    assert st.shape[1] % 8192 == 0
    assert mt.dtype == torch.int32
    np.testing.assert_array_equal(to_np(mt), to_np(mj))
    np.testing.assert_array_equal(to_np(st), to_np(sj))
    assert bool(ot) == bool(oj) is False


def test_kcover_slot_budget_overflow_flag(ctx):
    """A budget below the live fraction raises the overflow flag (and only
    truncates — never reads out-of-range records), as the reference."""
    sj, mj, oj = jkc.build_kcover_slot_buffer(
        ctx["scene_j"], jnp.asarray(ctx["vm"]), jnp.asarray(ctx["K"]), W, H,
        NEAR, FAR, slot_budget=0.05)
    st, mt, ot = tkc.build_kcover_slot_buffer(
        ctx["scene_t"], tt(ctx["vm"]), tt(ctx["K"]), W, H, NEAR, FAR,
        slot_budget=0.05)
    assert bool(ot) and bool(oj)
    assert isinstance(ot, torch.Tensor) and ot.dtype == torch.bool
    assert int(mt[1:].max()) <= st.shape[1]
    np.testing.assert_array_equal(to_np(mt), to_np(mj))
    np.testing.assert_array_equal(to_np(st), to_np(sj))


def test_slot_buffer_at_moved_pose_renders_like_reference(ctx):
    """Away from the identity a depth key may differ by an ulp between the
    packages, so compare what the buffer is FOR: the cover it yields."""
    vm = to_np(j_invert(jnp.asarray(perturbed_c2w((0.7, -0.4, 0.3),
                                                  (0.012, -0.01, 0.018)))))
    sj, mj, _ = jkc.build_kcover_slot_buffer(
        ctx["scene_j"], jnp.asarray(vm), jnp.asarray(ctx["K"]), W, H,
        NEAR, FAR)
    st, mt, _ = tkc.build_kcover_slot_buffer(
        ctx["scene_t"], tt(vm), tt(ctx["K"]), W, H, NEAR, FAR)
    assert tuple(st.shape) == tuple(sj.shape)
    cam = t_cam_vector(tt(vm), tt(ctx["K"]), W, H)
    r = []
    for s, m in ((tt(sj), tt(mj, torch.int32)), (st, mt)):
        kb = tkc.build_kcover_buffer(s, m, cam, N_TY, N_TX, NEAR, FAR,
                                     k_cover=K_COVER)
        r.append(tkc.render_kcover_ref(kb, cam, N_TY, N_TX, NEAR, FAR))
    # identical except where an ulp of depth swapped two neighbours
    assert (to_np(r[0][1]) != to_np(r[1][1])).mean() <= 0.01
    np.testing.assert_allclose(to_np(r[1][1]), to_np(r[0][1]), atol=2e-3)
    np.testing.assert_allclose(to_np(r[1][0]), to_np(r[0][0]), atol=2e-2)


# ----------------------------------------------------------------- select

def test_select_live_records_equal_reference(ctx):
    """The reference's TPU select gates liveness per 256-slot block and may
    admit hits AFTER a pixel's transmittance died into the tail of its
    K-list; the port's select is exact per pixel. Every record the port
    admits must be the reference's record at the same list position (the
    live prefix), and the reference may only have EXTRA tail records."""
    kb_j, kb_t = to_np(ctx["kb_j"]), to_np(ctx["kb_t"])
    assert kb_t.shape == kb_j.shape == (5, K_COVER, N_TY * N_TX * 8 * 256)
    live = kb_t[4] > 0.0  # (K, M_out): positions the port filled
    assert live.mean() > 0.1
    for r in range(5):
        np.testing.assert_array_equal(kb_t[r][live], kb_j[r][live])
    # the port never holds a record where the reference holds none
    assert not (live & ~(kb_j[4] > 0.0)).any()
    # lists are prefix-packed: no hole before a filled position
    assert (np.diff(live.astype(np.int8), axis=0) <= 0).all()


def test_select_renders_like_reference_select(ctx):
    """Both buffers through the SAME plain render: equal to within T_EPS
    (the post-death tail weighs <= T_EPS in total; measured far below)."""
    d_j, a_j = tkc.render_kcover_ref(tt(ctx["kb_j"]), ctx["cam_t"], N_TY,
                                     N_TX, NEAR, FAR)
    d_t, a_t = tkc.render_kcover_ref(ctx["kb_t"], ctx["cam_t"], N_TY, N_TX,
                                     NEAR, FAR)
    np.testing.assert_allclose(to_np(a_t), to_np(a_j), atol=1e-5)
    np.testing.assert_allclose(to_np(d_t), to_np(d_j), atol=1e-4)
    assert float(a_t.mean()) > 0.5


def test_select_uncovered_pixels_are_zero_records():
    """An empty slot buffer yields the all-zero cover buffer."""
    slot = torch.zeros((8, 8192))
    meta = torch.zeros((N_TY * N_TX * 8 + 2,), dtype=torch.int32)
    cam = t_cam_vector(torch.eye(4), tt(np.eye(3)), W, H)
    kb = tkc.select_kcover_records(slot, meta, cam, N_TY, N_TX, 8, NEAR, FAR)
    assert tuple(kb.shape) == (5, 8, N_TY * N_TX * 8 * 256)
    assert float(kb.abs().max()) == 0.0


# ------------------------------------------------------------ step render

def test_pixel_centers_match_reference():
    m_out = N_TY * N_TX * 8 * 256
    pxj, pyj = jkc._pixel_centers(N_TY, N_TX, m_out)
    pxt, pyt = tkc._pixel_centers(N_TY, N_TX, m_out)
    np.testing.assert_array_equal(to_np(pxt), to_np(pxj))
    np.testing.assert_array_equal(to_np(pyt), to_np(pyj))


@pytest.mark.parametrize("which", ["ref", "render"])
def test_forward_matches_reference_oracle(ctx, which):
    """Port forward (plain oracle form and the product entry point) vs the
    reference's plain-XLA oracle on the reference's cover buffer: 1e-5
    (f32 sums of <= 16 terms of O(1); contraction differs)."""
    f = tkc.render_kcover_ref if which == "ref" else tkc.render_kcover
    d_t, a_t = f(tt(ctx["kb_j"]), ctx["cam2_t"], N_TY, N_TX, NEAR, FAR)
    d_j, a_j = jkc.render_kcover_ref(ctx["kb_j"], ctx["cam2_j"], N_TY, N_TX,
                                     NEAR, FAR)
    assert tuple(d_t.shape) == (N_TY * 16, N_TX * 128)
    np.testing.assert_allclose(to_np(a_t), to_np(a_j), atol=1e-5)
    np.testing.assert_allclose(to_np(d_t), to_np(d_j), atol=1e-5)


def test_forward_matches_interpreted_pallas_step(ctx):
    """vs the reference's fused step kernel in interpret mode: 1e-4, the
    tolerance the reference's own test grants the interpreter's
    contraction order against its oracle."""
    d_t, a_t = tkc.render_kcover(tt(ctx["kb_j"]), ctx["cam2_t"], N_TY, N_TX,
                                 NEAR, FAR)
    d_p, a_p = jkc.render_kcover(ctx["kb_j"], ctx["cam2_j"], N_TY, N_TX,
                                 NEAR, FAR, impl="pallas")
    np.testing.assert_allclose(to_np(a_t), to_np(a_p), atol=1e-4)
    np.testing.assert_allclose(to_np(d_t), to_np(d_p), atol=1e-4)


def _cotangents():
    rng = np.random.default_rng(11)
    shape = (N_TY * 16, N_TX * 128)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def test_hand_written_backward_matches_autograd_in_port(ctx):
    """render_kcover's hand-written backward vs torch autograd through the
    plain forward, at the product level (quat / trans gradients: the raw dR
    rows carry a manifold-normal component that the quat -> R backward
    projects out, so d_cam itself is not comparable). 1e-4 relative: sums
    of ~5e5 signed terms in f32."""
    K = tt(ctx["K"])
    kbuf = tt(ctx["kb_j"])
    pose0 = TPose.from_c2w(tt(ctx["c2w"]))
    with torch.no_grad():
        tgt = tkc.render_kcover_ref(kbuf, ctx["cam2_t"], N_TY, N_TX,
                                    NEAR, FAR)[0] * 1.02

    def grads(f):
        q = pose0.quat.clone().requires_grad_(True)
        t = pose0.trans.clone().requires_grad_(True)
        vm = t_invert(TPose(q, t).to_c2w())
        d, a = f(kbuf, t_cam_vector(vm, K, W, H), N_TY, N_TX, NEAR, FAR)
        loss = ((d - tgt) ** 2).mean() + 0.1 * a.mean()
        return torch.autograd.grad(loss, (q, t))

    gq1, gt1 = grads(tkc.render_kcover)
    gq2, gt2 = grads(tkc.render_kcover_ref)
    assert float(gq2.abs().max()) > 0 and float(gt2.abs().max()) > 0
    assert_rel(gq1, gq2, 1e-4, "quat grad")
    assert_rel(gt1, gt2, 1e-4, "trans grad")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_d_cam_matches_reference(ctx, impl):
    """d_cam of the port's hand-written backward vs the reference's (its
    plain-XLA custom VJP and its interpreted Pallas backward kernel), same
    cover buffer, same cotangents: 1e-4 relative to the largest scalar."""
    gd, ga = _cotangents()
    cam = ctx["cam2_t"].clone().requires_grad_(True)
    d, a = tkc.render_kcover(tt(ctx["kb_j"]), cam, N_TY, N_TX, NEAR, FAR)
    (d * tt(gd)).sum().add((a * tt(ga)).sum()).backward()

    def f(c):
        dj, aj = jkc.render_kcover(ctx["kb_j"], c, N_TY, N_TX, NEAR, FAR,
                                   impl=impl)
        return jnp.sum(dj * gd) + jnp.sum(aj * ga)

    g_j = to_np(jax.grad(f)(ctx["cam2_j"]))
    g_t = to_np(cam.grad)
    assert g_t.shape == (18,)
    assert (g_t[:4] == 0).all() and (g_t[16:] == 0).all()
    assert_rel(g_t[4:16], g_j[4:16], 1e-4, "d_cam")


def test_cv_bwd_helper_matches_render_backward(ctx):
    """_kcover_cv_bwd (the plain version's backward as a function) returns
    what autograd gets through render_kcover on the CPU."""
    gd, ga = _cotangents()
    kbuf = tt(ctx["kb_j"])
    cam = ctx["cam2_t"].clone().requires_grad_(True)
    d, a = tkc.render_kcover(kbuf, cam, N_TY, N_TX, NEAR, FAR)
    (d * tt(gd)).sum().add((a * tt(ga)).sum()).backward()
    d_cam = tkc._kcover_cv_bwd(N_TY, N_TX, NEAR, FAR,
                               (kbuf, ctx["cam2_t"]), (tt(gd), tt(ga)))
    assert torch.equal(d_cam, cam.grad)


def test_step_live_gate_excludes_boundary_slot():
    """The slot whose INCLUSIVE transmittance crosses T_EPS is excluded
    entirely. Hand-built cover list: ten alpha~0.21 covers drive T to
    ~0.09, then an opaque record whose inclusive T crosses T_EPS — alpha
    stays ~0.91, NOT ~1; the reference gives the same pixel value."""
    h, w = 16, 128  # one sub-tile row
    K_np = np.array([[100.0, 0, w / 2 - 0.5], [0, 100.0, h / 2 - 0.5],
                     [0, 0, 1]], np.float32)
    m_out = h * w
    kbuf = np.zeros((tkc.NREC_KC, 16, m_out), np.float32)
    z = 1.0
    for k in range(10):
        x = (64 + 0.5 - K_np[0, 2]) / K_np[0, 0] * z
        y = (8 + 0.5 - K_np[1, 2]) / K_np[1, 1] * z
        kbuf[:, k, :] = np.array([x, y, z, 1e-4, 0.21], np.float32)[:, None]
        z += 1e-3
    x = (64 + 0.5 - K_np[0, 2]) / K_np[0, 0] * z
    y = (8 + 0.5 - K_np[1, 2]) / K_np[1, 1] * z
    kbuf[:, 10, :] = np.array([x, y, z + 1.0, 1.0, 1.0], np.float32)[:, None]
    cam_t = t_cam_vector(torch.eye(4), tt(K_np), w, h).requires_grad_(True)
    cam_j = j_cam_vector(jnp.eye(4), jnp.asarray(K_np), w, h)
    for f in (tkc.render_kcover_ref, tkc.render_kcover):
        d, a = f(tt(kbuf), cam_t, 1, 1, NEAR, FAR)
        a_px = float(a.detach()[8, 64])
        assert abs(a_px - (1.0 - 0.79 ** 10)) < 5e-3, a_px
        (g,) = torch.autograd.grad(d.sum(), cam_t)
        assert bool(torch.isfinite(g).all())
    d_j, a_j = jkc.render_kcover_ref(jnp.asarray(kbuf), cam_j, 1, 1,
                                     NEAR, FAR)
    np.testing.assert_allclose(to_np(a.detach()), to_np(a_j), atol=1e-6)
    np.testing.assert_allclose(to_np(d.detach()), to_np(d_j), atol=1e-5)


def test_render_tracking_depth_kcover_matches_reference(ctx):
    vm = to_np(j_invert(jnp.asarray(ctx["c2w"])))
    d_j, a_j = jkc.render_tracking_depth_kcover(
        jnp.asarray(vm), jnp.asarray(ctx["K"]), W, H, ctx["kb_j"])
    d_t, a_t = tkc.render_tracking_depth_kcover(
        tt(vm), tt(ctx["K"]), W, H, tt(ctx["kb_j"]))
    assert tuple(d_t.shape) == (H, W)
    np.testing.assert_allclose(to_np(a_t), to_np(a_j), atol=1e-5)
    # depth = d_acc / alpha: the division amplifies an ulp at tiny alpha
    np.testing.assert_allclose(to_np(d_t), to_np(d_j), atol=1e-4)
