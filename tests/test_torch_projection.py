"""Port vs reference: the shared pose-path math (cam vector, per-slot
projection, 8-row packing, pose chain) and the binning-facing projections.
Tolerance 1e-5 relative to each array's scale: elementwise f32 algebra
whose fused-multiply-add contraction differs between XLA and PyTorch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplatloc_tpu.ops import fused_tracking as jft
from gsplatloc_tpu.ops import projection as jproj
from gsplatloc_tpu.ops.lie import invert_se3 as j_invert
from gsplatloc_tpu_torch.ops import fused_tracking as tft
from gsplatloc_tpu_torch.ops import projection as tproj
from torch_port_helpers import assert_rel, box_scene, perturbed_c2w, to_np, tt

RTOL = 1e-5
H, W = 64, 128


def _cam_np(c2w=None):
    from torch_port_helpers import intrinsics

    K = intrinsics(H, W)
    c2w = perturbed_c2w() if c2w is None else c2w
    vm = np.asarray(j_invert(jnp.asarray(c2w)))
    return K, vm


def _records(n=4096, seed=0):
    """(8, n) iso slot records in front of the camera, a few behind/near."""
    rng = np.random.default_rng(seed)
    rec = np.zeros((8, n), np.float32)
    rec[0] = rng.uniform(-2.0, 2.0, n)
    rec[1] = rng.uniform(-1.0, 1.0, n)
    rec[2] = rng.uniform(0.5, 4.0, n)
    rec[2, :16] = rng.uniform(-1.0, 0.005, 16)  # behind / inside near plane
    rec[3] = rng.uniform(1e-6, 4e-3, n)
    rec[4] = rng.uniform(0.2, 1.0, n)
    rec[:, -1] = 0.0  # the dummy record
    return rec


def test_cam_vector_matches_reference():
    K, vm = _cam_np()
    cj = jft.cam_vector(jnp.asarray(vm), jnp.asarray(K), W, H)
    ct = tft.cam_vector(tt(vm), tt(K), W, H)
    assert ct.shape == (tft.N_CAM,) and tft.N_CAM == jft.N_CAM
    np.testing.assert_array_equal(to_np(ct), to_np(cj))


_FLOAT_KEYS = ["qx", "qy", "qz", "zs", "iz", "u", "v", "j00", "j02", "j11",
               "j12", "txc", "tyc", "a", "b", "c", "inv_det", "ca", "cb",
               "cc"]
_BOOL_KEYS = ["det_ok", "lim_ok_x", "lim_ok_y"]


@pytest.fixture(scope="module")
def parts():
    K, vm = _cam_np()
    rec = _records()
    cam_j = jft.cam_vector(jnp.asarray(vm), jnp.asarray(K), W, H)
    cam_t = tft.cam_vector(tt(vm), tt(K), W, H)
    pj = jft._project_slots(jnp.asarray(rec), cam_j)
    pt = tft._project_slots(tt(rec), cam_t)
    return rec, cam_j, cam_t, pj, pt


@pytest.mark.parametrize("key", _FLOAT_KEYS)
def test_project_parts_field_matches_reference(parts, key):
    _rec, _cj, _ct, pj, pt = parts
    assert_rel(pt[key], pj[key], RTOL, key)


@pytest.mark.parametrize("key", _BOOL_KEYS)
def test_project_parts_gate_matches_reference(parts, key):
    _rec, _cj, _ct, pj, pt = parts
    np.testing.assert_array_equal(to_np(pt[key]), to_np(pj[key]))


def test_project8_rows_matches_reference(parts):
    _rec, _cj, _ct, pj, pt = parts
    rj = to_np(jft._project8_rows(pj, 1e-2, 1e10))
    rt = to_np(tft._project8_rows(pt, 1e-2, 1e10))
    assert rt.shape == rj.shape == (8, 4096)
    for i in range(8):
        assert_rel(rt[i], rj[i], RTOL, f"row {i}")
    np.testing.assert_array_equal(rt[7], rj[7])  # the validity gate
    assert rt[7, :16].sum() == 0 and rt[6, -1] == 0


@pytest.mark.parametrize("reduce", [True, False])
def test_pose_chain_matches_reference(parts, reduce):
    rec, cam_j, cam_t, pj, pt = parts
    rng = np.random.default_rng(1)
    n = rec.shape[1]
    mom = rng.normal(size=(7, 1, n)).astype(np.float32)
    # valid slots only: the chain is linear in the moments
    mom[:, :, :16] = 0.0
    dj = jft._pose_chain(pj, *[jnp.asarray(m) for m in mom], 24.0, 16.0,
                         cam_j[0], cam_j[1], reduce=reduce)
    dt = tft._pose_chain(pt, *[tt(m) for m in mom], 24.0, 16.0,
                         cam_t[0], cam_t[1], reduce=reduce)
    if reduce:
        assert tuple(dt.shape) == (1, 16)
        # a sum of 4096 signed terms: relative to the largest partial
        assert_rel(dt, dj, 1e-4, "chain")
    else:
        assert len(dt) == len(dj) == 12
        for a, b in zip(dt, dj):
            assert_rel(a, b, 1e-4, "chain map")


def _proj_fields(pt, pj, with_conic):
    assert_rel(pt.mean2d, pj.mean2d, RTOL, "mean2d")
    assert_rel(pt.depth, pj.depth, RTOL, "depth")
    if with_conic:
        assert_rel(pt.conic, pj.conic, 1e-4, "conic")
    # the integer radius / validity gates may differ only on measure-zero
    # ceil() ties of a value that differs by an ulp
    r_t, r_j = to_np(pt.radius), to_np(pj.radius)
    assert r_t.dtype == np.int32
    assert (r_t != r_j).mean() <= 1e-3
    assert np.abs(r_t - r_j).max() <= 1
    assert (to_np(pt.valid) != to_np(pj.valid)).mean() <= 1e-3


def test_project_iso_binning_matches_reference():
    scene_j, scene_t, K = box_scene(H, W)
    _K, vm = _cam_np()
    pj = jproj.project_iso_binning(
        scene_j.means, scene_j.scales[:, 0] ** 2, jnp.asarray(vm),
        jnp.asarray(K), W, H, 1e-2, 1e10)
    pt = tproj.project_iso_binning(
        scene_t.means, scene_t.scales[:, 0] * scene_t.scales[:, 0], tt(vm),
        tt(K), W, H, 1e-2, 1e10)
    assert pt.conic is None and pt.opacity_comp is None
    _proj_fields(pt, pj, with_conic=False)


@pytest.mark.parametrize("antialiased", [False, True])
def test_project_gaussians_matches_reference(antialiased):
    scene_j, scene_t, K = box_scene(H, W)
    _K, vm = _cam_np()
    pj = jproj.project_gaussians(
        scene_j.means, scene_j.quats, scene_j.scales, jnp.asarray(vm),
        jnp.asarray(K), W, H, antialiased=antialiased)
    pt = tproj.project_gaussians(
        scene_t.means, scene_t.quats, scene_t.scales, tt(vm), tt(K), W, H,
        antialiased=antialiased)
    _proj_fields(pt, pj, with_conic=True)
    if antialiased:
        assert_rel(pt.opacity_comp, pj.opacity_comp, 1e-4, "comp")
    else:
        assert pt.opacity_comp is None


def test_project_gaussians_anisotropic_matches_reference():
    """General quats / scales through the 3x3 covariance products."""
    rng = np.random.default_rng(2)
    n = 2000
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n),
                      rng.uniform(1, 4, n)], 1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(0.01, 0.08, (n, 3)).astype(np.float32)
    K, vm = _cam_np()
    pj = jproj.project_gaussians(
        jnp.asarray(means), jnp.asarray(quats), jnp.asarray(scales),
        jnp.asarray(vm), jnp.asarray(K), W, H)
    pt = tproj.project_gaussians(tt(means), tt(quats), tt(scales), tt(vm),
                                 tt(K), W, H)
    _proj_fields(pt, pj, with_conic=True)


def test_iso_projection_agrees_with_general_in_port():
    """project_iso_binning folds what project_gaussians computes in full."""
    _sj, scene_t, K = box_scene(H, W)
    _K, vm = _cam_np()
    pi = tproj.project_iso_binning(
        scene_t.means, scene_t.scales[:, 0] * scene_t.scales[:, 0], tt(vm),
        tt(K), W, H)
    pg = tproj.project_gaussians(scene_t.means, scene_t.quats,
                                 scene_t.scales, tt(vm), tt(K), W, H)
    assert torch.equal(pi.mean2d, pg.mean2d)
    assert (pi.radius != pg.radius).float().mean() <= 1e-3
    assert (pi.valid != pg.valid).float().mean() <= 1e-3
