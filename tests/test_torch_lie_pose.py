"""Port vs reference: rotation / SE(3) numerics, pose parameterization and
camera geometry. Tolerance 1e-6 absolute (elementwise f32 algebra on O(1)
values; only the association of a few sums can differ), looser only where
a value is O(10)."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from gsplatloc_tpu.models import pose as jpose
from gsplatloc_tpu.ops import camera as jcamera
from gsplatloc_tpu.ops import lie as jlie
from gsplatloc_tpu_torch.models import pose as tpose
from gsplatloc_tpu_torch.ops import camera as tcamera
from gsplatloc_tpu_torch.ops import lie as tlie
from torch_port_helpers import to_np, tt

ATOL = 1e-6


def _rots(n, seed):
    return Rotation.random(n, random_state=np.random.RandomState(seed))


def _inputs(name):
    rng = np.random.default_rng(3)
    if name in ("normalize_quat", "quat_to_rotmat"):
        return (rng.normal(size=(64, 4)).astype(np.float32),)
    if name in ("rotmat_to_quat", "matrix_to_rotation_6d"):
        return (_rots(64, 1).as_matrix().astype(np.float32),)
    if name == "rotation_6d_to_matrix":
        return (rng.normal(size=(16, 6)).astype(np.float32),)
    if name == "construct_pose":
        return (_rots(4, 2).as_matrix().astype(np.float32),
                rng.normal(size=(4, 3)).astype(np.float32))
    if name == "invert_se3":
        T = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
        T[:, :3, :3] = _rots(5, 3).as_matrix()
        T[:, :3, 3] = rng.normal(size=(5, 3))
        return (T,)
    if name == "transform_points":
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = _rots(1, 4).as_matrix()[0]
        T[:3, 3] = rng.normal(size=3)
        return (T, rng.normal(size=(100, 3)).astype(np.float32))
    if name == "se3_exp":
        return (rng.normal(scale=0.3, size=6).astype(np.float32),)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "normalize_quat", "quat_to_rotmat", "rotmat_to_quat",
    "rotation_6d_to_matrix", "matrix_to_rotation_6d", "construct_pose",
    "invert_se3", "transform_points", "se3_exp",
])
def test_lie_function_matches_reference(name):
    args = _inputs(name)
    ref = getattr(jlie, name)(*[jnp.asarray(a) for a in args])
    got = getattr(tlie, name)(*[tt(a) for a in args])
    np.testing.assert_allclose(to_np(got), to_np(ref), atol=ATOL, rtol=0)


def test_se3_exp_small_angle_matches_reference():
    xi = np.array([1e-8, -2e-8, 1e-8, 0.1, 0.2, -0.3], np.float32)
    np.testing.assert_allclose(to_np(tlie.se3_exp(tt(xi))),
                               to_np(jlie.se3_exp(jnp.asarray(xi))),
                               atol=ATOL, rtol=0)


def test_quat_to_rotmat_matches_scipy():
    rots = _rots(64, 1)
    q_wxyz = np.roll(rots.as_quat(), 1, axis=1).astype(np.float32)
    ours = to_np(tlie.quat_to_rotmat(tt(q_wxyz)))
    np.testing.assert_allclose(ours, rots.as_matrix(), atol=2e-6)


@pytest.mark.parametrize("case", ["w", "x", "y", "z"])
def test_rotmat_to_quat_branches_match_reference(case):
    """Each Shepperd branch (largest pivot w / x / y / z)."""
    ang = {"w": [10, 5, -8], "x": [179, 3, 2], "y": [2, 179, 3],
           "z": [3, 2, 179]}[case]
    m = Rotation.from_euler("xyz", ang, degrees=True).as_matrix() \
        .astype(np.float32)
    np.testing.assert_allclose(
        to_np(tlie.rotmat_to_quat(tt(m))),
        to_np(jlie.rotmat_to_quat(jnp.asarray(m))), atol=ATOL, rtol=0)


def test_quat_gradient_matches_reference():
    """d(R)/d(quat) contracted with a fixed cotangent."""
    import jax

    q = np.array([0.9, 0.1, -0.3, 0.2], np.float32)
    cot = np.random.default_rng(0).normal(size=(3, 3)).astype(np.float32)
    g_ref = jax.grad(lambda x: jnp.sum(jlie.quat_to_rotmat(x) * cot))(
        jnp.asarray(q))
    qt = tt(q).requires_grad_(True)
    (tlie.quat_to_rotmat(qt) * tt(cot)).sum().backward()
    np.testing.assert_allclose(to_np(qt.grad), to_np(g_ref), atol=2e-6, rtol=0)


def test_pose_state_roundtrip_matches_reference():
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = _rots(1, 7).as_matrix()[0]
    c2w[:3, 3] = [0.3, -1.2, 2.0]
    pj = jpose.PoseState.from_c2w(jnp.asarray(c2w))
    pt = tpose.PoseState.from_c2w(tt(c2w))
    np.testing.assert_allclose(to_np(pt.quat), to_np(pj.quat), atol=ATOL)
    np.testing.assert_allclose(to_np(pt.trans), to_np(pj.trans), atol=ATOL)
    np.testing.assert_allclose(to_np(pt.to_c2w()), to_np(pj.to_c2w()),
                               atol=ATOL)
    np.testing.assert_allclose(to_np(pt.to_c2w()), c2w, atol=2e-6)


def test_predict_next_pose_matches_reference():
    rng = np.random.default_rng(5)
    a = [rng.normal(size=4).astype(np.float32),
         rng.normal(size=3).astype(np.float32)]
    b = [a[0] + 0.01 * rng.normal(size=4).astype(np.float32),
         a[1] + 0.01 * rng.normal(size=3).astype(np.float32)]
    rj = jpose.predict_next_pose(jpose.PoseState(*map(jnp.asarray, a)),
                                 jpose.PoseState(*map(jnp.asarray, b)))
    rt = tpose.predict_next_pose(tpose.PoseState(*map(tt, a)),
                                 tpose.PoseState(*map(tt, b)))
    np.testing.assert_allclose(to_np(rt.quat), to_np(rj.quat), atol=ATOL)
    np.testing.assert_allclose(to_np(rt.trans), to_np(rj.trans), atol=ATOL)


def test_camera_geometry_matches_reference():
    rng = np.random.default_rng(9)
    depth = (1.0 + rng.random((24, 40))).astype(np.float32)
    Kj = jcamera.intrinsics_matrix(50.0, 52.0, 19.5, 11.5)
    Kt = tcamera.intrinsics_matrix(50.0, 52.0, 19.5, 11.5)
    np.testing.assert_array_equal(to_np(Kt), to_np(Kj))
    pj = jcamera.depth_to_points(jnp.asarray(depth), Kj)
    pt = tcamera.depth_to_points(tt(depth), Kt)
    np.testing.assert_allclose(to_np(pt), to_np(pj), atol=ATOL)
    np.testing.assert_allclose(
        to_np(tcamera.points_to_depth_grid(pt, 24, 40)),
        to_np(jcamera.points_to_depth_grid(pj, 24, 40)), atol=ATOL)
    nj = jcamera.depth_to_normal(jnp.asarray(depth), Kj)
    nt = tcamera.depth_to_normal(tt(depth), Kt)
    # unit normals from cross products of O(0.1) differences: 1e-5
    np.testing.assert_allclose(to_np(nt), to_np(nj), atol=1e-5)
