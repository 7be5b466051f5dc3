"""Port vs reference: the sub-tile forward render (layout helpers, slot
buffer, projection phase, compositing walk). On the CPU the port's
wrappers take their plain PyTorch versions; the reference's Pallas
forward runs in interpret mode, and its general rasterizer is the oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gsplatloc_tpu.data.synthetic import random_gaussian_cloud
from gsplatloc_tpu.models.gaussians import scene_from_point_cloud
from gsplatloc_tpu.ops import fused_subtile as jfs
from gsplatloc_tpu.ops.fused_tracking import cam_vector as j_cam_vector
from gsplatloc_tpu.ops.lie import invert_se3 as j_invert
from gsplatloc_tpu.ops.rasterize import rasterize
from gsplatloc_tpu_torch.convert import scene_from_numpy
from gsplatloc_tpu_torch.ops import fused_subtile as tfs
from gsplatloc_tpu_torch.ops.fused_tracking import cam_vector as t_cam_vector
from helpers import assert_close_except_gate_flips
from torch_port_helpers import assert_rel, box_scene, to_np, tt

NEAR, FAR = 1e-2, 1e10


def _cloud_scene(n=500, seed=0, opacity=1.0):
    """Random cloud with heterogeneous ISOTROPIC scales, in both packages."""
    rng = np.random.default_rng(seed)
    pts, rgb = random_gaussian_cloud(rng, n)
    scene = scene_from_point_cloud(jnp.asarray(pts), jnp.asarray(rgb))
    s = rng.uniform(0.02, 0.08, (n, 1)).astype(np.float32)
    scene = scene._replace(
        scales=jnp.asarray(np.repeat(s, 3, axis=1)),
        opacities=jnp.full_like(scene.opacities, opacity))
    scene_t = scene_from_numpy(
        {k: np.asarray(getattr(scene, k)) for k in scene._fields},
        device="cpu")
    return scene, scene_t


def _viewmat(angles=(0, 0, 0), t=(0, 0, 0)):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = Rotation.from_euler("xyz", angles, degrees=True).as_matrix()
    c2w[:3, 3] = t
    return to_np(j_invert(jnp.asarray(c2w)))


@pytest.mark.parametrize("name", ["SUB_W", "SUB_H", "KX_SUB", "KY_SUB",
                                  "N_SUB_X", "N_SUB_Y", "N_SUB", "P_SUB",
                                  "NUM_PROJ_ROWS", "CB", "SIG_EPS", "CHUNK",
                                  "ALPHA_MIN", "ALPHA_MAX", "T_EPS"])
def test_constants_match_reference(name):
    assert getattr(tfs, name) == getattr(jfs, name)


def test_scramble_layout_matches_reference():
    n_ty, n_tx = 3, 2
    img = np.random.default_rng(0).normal(
        size=(n_ty * 16, n_tx * 128)).astype(np.float32)
    fj = jfs.scramble_image(jnp.asarray(img), n_ty, n_tx)
    ft = tfs.scramble_image(tt(img), n_ty, n_tx)
    np.testing.assert_array_equal(to_np(ft), to_np(fj))
    back = tfs.unscramble_image(ft, n_ty, n_tx)
    np.testing.assert_array_equal(to_np(back), img)
    np.testing.assert_array_equal(
        to_np(back), to_np(jfs.unscramble_image(fj, n_ty, n_tx)))


def test_segment_ids_and_origins_match_reference():
    n_tx = 3
    for ti in range(2):
        for tj in range(n_tx):
            for s in range(tfs.N_SUB):
                assert tfs._seg_id(ti, tj, n_tx, s) == int(
                    jfs._seg_id(ti, tj, n_tx, s))
                xj, yj = jfs._sub_origin(jnp.int32(ti), jnp.int32(tj), s)
                assert tfs._sub_origin(ti, tj, s) == (float(xj), float(yj))
    np.testing.assert_array_equal(to_np(tfs._sub_mono("cpu")),
                                  to_np(jfs._sub_mono()))


@pytest.fixture(scope="module")
def cloud():
    h, w = 48, 160
    scene_j, scene_t = _cloud_scene(500)
    K = np.array([[80.0, 0, w / 2 - 0.5], [0, 80.0, h / 2 - 0.5], [0, 0, 1]],
                 np.float32)
    vm = _viewmat((1, -2, 0.5), (0.02, 0.01, -0.03))
    slot_j, meta_j, bin_j = jfs.build_subtile_slot_buffer(
        scene_j, jnp.asarray(vm), jnp.asarray(K), w, h, NEAR, FAR)
    slot_t, meta_t, bin_t = tfs.build_subtile_slot_buffer(
        scene_t, tt(vm), tt(K), w, h, NEAR, FAR)
    return dict(h=h, w=w, K=K, vm=vm, scene_j=scene_j, scene_t=scene_t,
                slot_j=slot_j, meta_j=meta_j, slot_t=slot_t, meta_t=meta_t,
                bin_j=bin_j, bin_t=bin_t)


def test_subtile_slot_buffer_matches_reference(cloud):
    """Chunk-padded layout: equal segment offsets; the slot ORDER may swap
    two neighbours whose depth keys differ by an ulp between the packages,
    so the records are held as per-segment multisets via their sums."""
    mj, mt = to_np(cloud["meta_j"]), to_np(cloud["meta_t"])
    np.testing.assert_array_equal(mt, mj)
    assert (mt[1:] % 128 == 0).all()
    sj, st = to_np(cloud["slot_j"]), to_np(cloud["slot_t"])
    assert st.shape == sj.shape and st.shape[0] == 8
    assert st.shape[1] % 8192 == 0
    same = (st == sj).all(axis=0).mean()
    assert same > 0.99, same
    np.testing.assert_allclose(st.sum(axis=1), sj.sum(axis=1), rtol=1e-5)


def test_project8_matches_reference(cloud):
    cam_j = j_cam_vector(jnp.asarray(cloud["vm"]), jnp.asarray(cloud["K"]),
                         cloud["w"], cloud["h"])
    cam_t = t_cam_vector(tt(cloud["vm"]), tt(cloud["K"]), cloud["w"],
                         cloud["h"])
    pj = to_np(jfs._project8(cloud["slot_j"], cam_j, NEAR, FAR))
    for f in (tfs._project8, tfs.project8):
        pt = to_np(f(tt(cloud["slot_j"]), cam_t, NEAR, FAR))
        assert pt.shape == pj.shape
        for i in range(8):
            assert_rel(pt[i], pj[i], 1e-5, f"row {i}")
        np.testing.assert_array_equal(pt[7], pj[7])


def test_walk_matches_interpreted_pallas_forward(cloud):
    """Same projected slots, same meta: the port's walk vs the reference's
    forward kernel (interpret mode). The kernel's in-chunk scans multiply
    in another order, so a pixel on a gate's knife edge may flip; all others
    agree to summation noise. Chunks-done counts are equal."""
    h, w = cloud["h"], cloud["w"]
    n_ty, n_tx = -(-h // 16), -(-w // 128)
    cam_j = j_cam_vector(jnp.asarray(cloud["vm"]), jnp.asarray(cloud["K"]),
                         w, h)
    p8 = jfs._project8(cloud["slot_j"], cam_j, NEAR, FAR)
    out_j, cd_j = jfs._subtile_fwd_impl(p8, cloud["meta_j"], n_ty, n_tx)
    out_t, cd_t = tfs.subtile_fwd(tt(p8), tt(cloud["meta_j"], torch.int32),
                                  n_ty, n_tx)
    assert tuple(out_t.shape) == (2, n_ty * n_tx * 8 * 256)
    assert cd_t.dtype == torch.int32
    np.testing.assert_array_equal(to_np(cd_t), to_np(cd_j))
    assert_close_except_gate_flips(to_np(out_t[1]), to_np(out_j[1]),
                                   atol=3e-5)
    assert_close_except_gate_flips(to_np(out_t[0]), to_np(out_j[0]),
                                   atol=3e-4, flip_abs=0.3)


def test_subtile_forward_matches_general_oracle(cloud):
    """The port's whole sub-tile forward vs the reference's general
    rasterizer, with the reference test's own tolerances."""
    h, w = cloud["h"], cloud["w"]
    s = cloud["scene_j"]
    ref, a_ref = rasterize(
        s.means, s.quats, s.scales, s.opacities, s.sh_coeffs,
        jnp.asarray(cloud["vm"]), jnp.asarray(cloud["K"]), w, h,
        sh_degree=1, render_mode="ED", backend="pallas")
    d_sub, a_sub = tfs.render_tracking_depth_subtile(
        tt(cloud["vm"]), tt(cloud["K"]), w, h, cloud["slot_t"],
        cloud["meta_t"])
    assert tuple(d_sub.shape) == (h, w)
    assert_close_except_gate_flips(to_np(a_sub), to_np(a_ref)[..., 0]
                                   if np.ndim(a_ref) == 3 else to_np(a_ref),
                                   atol=3e-5)
    assert_close_except_gate_flips(to_np(d_sub), to_np(ref[..., 0]),
                                   atol=3e-4, flip_abs=0.3)


def test_subtile_forward_matches_reference_subtile(cloud):
    h, w = cloud["h"], cloud["w"]
    d_j, a_j = jfs.render_tracking_depth_subtile(
        jnp.asarray(cloud["vm"]), jnp.asarray(cloud["K"]), w, h,
        cloud["slot_j"], cloud["meta_j"])
    d_t, a_t = tfs.render_tracking_depth_subtile(
        tt(cloud["vm"]), tt(cloud["K"]), w, h, cloud["slot_t"],
        cloud["meta_t"])
    assert_close_except_gate_flips(to_np(a_t), to_np(a_j), atol=3e-5)
    assert_close_except_gate_flips(to_np(d_t), to_np(d_j), atol=3e-4,
                                   flip_abs=0.3)


def test_box_room_depth_target_matches_reference():
    """The depth-target use: a dense depth-image scene at its own pose."""
    h, w = 64, 128
    scene_j, scene_t, K = box_scene(h, w)
    vm = np.eye(4, dtype=np.float32)
    sj, mj, _ = jfs.build_subtile_slot_buffer(
        scene_j, jnp.asarray(vm), jnp.asarray(K), w, h, NEAR, FAR)
    d_j, a_j = jfs.render_tracking_depth_subtile(
        jnp.asarray(vm), jnp.asarray(K), w, h, sj, mj)
    st, mt, _ = tfs.build_subtile_slot_buffer(
        scene_t, tt(vm), tt(K), w, h, NEAR, FAR)
    np.testing.assert_array_equal(to_np(mt), to_np(mj))
    np.testing.assert_array_equal(to_np(st), to_np(sj))
    d_t, a_t = tfs.render_tracking_depth_subtile(tt(vm), tt(K), w, h, st, mt)
    assert_close_except_gate_flips(to_np(a_t), to_np(a_j), atol=3e-5)
    assert_close_except_gate_flips(to_np(d_t), to_np(d_j), atol=3e-4,
                                   flip_abs=0.3)
    assert float(a_t.mean()) > 0.5


def test_early_stop_counts_chunks_like_reference():
    """Opaque wall in front of a deep stack: the walk stops at the first
    chunk boundary where every pixel is dead, and says how many 128-slot
    chunks it walked."""
    n_ty, n_tx = 1, 1
    n_seg = 8
    m_pad = 8192
    p8 = np.zeros((8, m_pad), np.float32)
    # segment 0: 3 chunks of opaque, image-filling splats centred in it
    p8[0, :384] = 8.0
    p8[1, :384] = 8.0
    p8[2, :384] = 1e-4  # ca
    p8[4, :384] = 1e-4  # cc
    p8[5, :384] = np.linspace(1.0, 2.0, 384)
    p8[6, :384] = 1.0
    p8[7, :384] = 1.0
    meta = np.zeros(n_seg + 2, np.int32)
    meta[2:] = 384
    out_t, cd_t = tfs.subtile_fwd(tt(p8), tt(meta, torch.int32), n_ty, n_tx)
    out_j, cd_j = jfs._subtile_fwd_impl(jnp.asarray(p8), jnp.asarray(meta),
                                        n_ty, n_tx)
    np.testing.assert_array_equal(to_np(cd_t), to_np(cd_j))
    assert int(cd_t[0]) == 1 and int(cd_t[1:].sum()) == 0
    np.testing.assert_allclose(to_np(out_t), to_np(out_j)[:2], atol=1e-5)
    # alpha 0.999 then the crossing slot is excluded: 0.999, not 1
    assert abs(float(out_t[1, 7 * 16 + 7]) - 0.999) < 1e-5


def test_backward_through_subtile_render_raises(cloud):
    vm = tt(cloud["vm"]).requires_grad_(True)
    d, _a = tfs.render_tracking_depth_subtile(
        vm, tt(cloud["K"]), cloud["w"], cloud["h"], cloud["slot_t"],
        cloud["meta_t"])
    with pytest.raises(NotImplementedError):
        d.sum().backward()
