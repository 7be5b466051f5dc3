"""The port's dense hybrid RGB-D odometry (HYBRID, tracking/odometry.py)
against the JAX package's on the CPU, and the three cases of
tests/test_odometry.py through the port.

Both packages compute in float32 on the CPU (the reference's H6 at
HIGHEST, its g6 at the default precision, which is float32 on the CPU;
the port's matmuls in float32 with TF32 off). Tolerances: the pyramid
and sampling helpers equal the reference's bit for bit; the estimated
transform within 2e-6 (rotation) / 2e-6 m (translation) of the
reference's after 30 Gauss-Newton steps."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gsplatloc_tpu.data.synthetic import box_room_frame
from gsplatloc_tpu.tracking import odometry as jodo
from gsplatloc_tpu_torch.tracking import odometry as todo
from torch_port_helpers import to_np, tt

CPU = "cpu"


def _K(h, w, f):
    return np.array([[f, 0, w / 2 - 0.5], [0, f, h / 2 - 0.5], [0, 0, 1]],
                    np.float32)


def _errors(T_est, T_true):
    eT = np.linalg.norm(T_est[:3, 3] - T_true[:3, 3])
    dR = T_est[:3, :3] @ T_true[:3, :3].T
    eR = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    return eT, eR


def _moved_pair(h=120, w=160):
    K = _K(h, w, 100.0)
    c2w_s = np.eye(4)
    c2w_s[:3, :3] = Rotation.from_euler("xyz", [1.0, -0.8, 0.5],
                                        degrees=True).as_matrix()
    c2w_s[:3, 3] = [0.02, -0.015, 0.03]
    rgb_t, depth_t = box_room_frame(np.eye(4), K, h, w)
    rgb_s, depth_s = box_room_frame(c2w_s, K, h, w)
    return (rgb_s, depth_s, rgb_t, depth_t, K), c2w_s


def test_hybrid_odometry_recovers_motion():
    args, c2w_s = _moved_pair()
    T_est = todo.rgbd_odometry_multi_scale(*args, levels=3,
                                           iterations=(10, 10, 10),
                                           device=CPU)
    eT, eR = _errors(T_est, c2w_s)  # target at identity
    # init error: ~4.2 cm / 1.4 deg; dense GN gets close to exact
    assert eT < np.linalg.norm(c2w_s[:3, 3]) / 10, eT
    assert eR < 0.2, eR


def test_hybrid_odometry_identity_stays_identity():
    h, w = 60, 80
    K = _K(h, w, 60.0)
    rgb, depth = box_room_frame(np.eye(4), K, h, w)
    T = todo.rgbd_odometry_multi_scale(rgb, depth, rgb, depth, K, levels=2,
                                       iterations=(5, 5), device=CPU)
    np.testing.assert_allclose(T, np.eye(4), atol=1e-4)


def _holes_case():
    h, w = 60, 80
    K = _K(h, w, 60.0)
    rgb, depth = box_room_frame(np.eye(4), K, h, w)
    depth_holes = depth.copy()
    rng = np.random.default_rng(9)
    for _ in range(25):  # sensor-dropout blobs over the target depth
        y = rng.integers(2, h - 6)
        x = rng.integers(2, w - 6)
        depth_holes[y:y + 4, x:x + 4] = 0.0
    T0 = np.eye(4)
    T0[:3, 3] = [0.004, -0.003, 0.005]
    return (rgb, depth, rgb, depth_holes, K), T0


def test_hybrid_odometry_depth_holes_no_bias():
    """Invalid (0) target-depth pixels are rejected from bilinear sampling
    and the gradients; from a perturbed init (fractional warps blend
    corners) the solve converges back to identity."""
    args, T0 = _holes_case()
    T = todo.rgbd_odometry_multi_scale(*args, init_T=T0, levels=2,
                                       iterations=(12, 12), device=CPU)
    eT, eR = _errors(T, np.eye(4))
    assert eT < 2e-4, eT
    assert eR < 0.02, eR


@pytest.mark.parametrize("case", ["moved", "holes"])
def test_port_matches_the_reference(case):
    if case == "moved":
        args, _ = _moved_pair()
        kw = dict(levels=3, iterations=(10, 10, 10))
    else:
        args, T0 = _holes_case()
        kw = dict(init_T=T0, levels=2, iterations=(12, 12))
    want = np.asarray(jodo.rgbd_odometry_multi_scale(*args, **kw))
    got = todo.rgbd_odometry_multi_scale(*args, **kw, device=CPU)
    assert got.dtype == np.float32 and got.shape == (4, 4)
    np.testing.assert_allclose(got[:3, :3], want[:3, :3], atol=2e-6)
    np.testing.assert_allclose(got[:3, 3], want[:3, 3], atol=2e-6)


def test_pyramid_and_sampling_equal_the_reference():
    rng = np.random.default_rng(4)
    img = rng.random((30, 42)).astype(np.float32)
    depth = np.where(rng.random((30, 42)) < 0.2, 0.0,
                     rng.random((30, 42)) * 3).astype(np.float32)
    valid = depth > 0
    u = rng.uniform(-2, 44, (30, 42)).astype(np.float32)
    v = rng.uniform(-2, 32, (30, 42)).astype(np.float32)
    pairs = [
        (jodo._downsample2(img), todo._downsample2(tt(img))),
        (jodo._downsample_depth(depth), todo._downsample_depth(tt(depth))),
        *zip(jodo._gradients(img), todo._gradients(tt(img))),
        *zip(jodo._masked_gradients(depth, valid),
             todo._masked_gradients(tt(depth), torch.as_tensor(valid))),
        *zip(jodo._bilinear(img, u, v), todo._bilinear(tt(img), tt(u),
                                                       tt(v))),
        *zip(jodo._bilinear_valid(depth, valid, u, v),
             todo._bilinear_valid(tt(depth), torch.as_tensor(valid), tt(u),
                                  tt(v))),
    ]
    for want, got in pairs:
        assert np.array_equal(to_np(got), np.asarray(want))


def test_odometry_refuses_the_cpu_by_itself():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args, _ = _moved_pair(24, 32)
    with pytest.raises(RuntimeError, match="cuda"):
        todo.rgbd_odometry_multi_scale(*args)
