"""Shared helpers of the tests that hold the PyTorch port against the JAX
reference: the same numpy inputs go through both packages on the CPU."""

import jax.numpy as jnp
import numpy as np
import torch

from gsplatloc_tpu.data.synthetic import box_room_frame
from gsplatloc_tpu.models.gaussians import scene_from_point_cloud
from gsplatloc_tpu.ops import camera
from gsplatloc_tpu_torch.convert import scene_from_numpy

CPU = "cpu"

# The tests run several worker processes side by side on small tensors:
# one intra-op thread each, or the workers' thread pools fight over the
# cores and a 10 s test takes minutes.
torch.set_num_threads(1)


def to_np(x):
    """jax array / torch tensor / python scalar -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tt(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def intrinsics(h, w):
    return np.array([[0.5 * w, 0, w / 2 - 0.5], [0, 0.5 * w, h / 2 - 0.5],
                     [0, 0, 1]], np.float32)


def box_scene(h=64, w=128, clutter=10):
    """A box-room frame as a frozen scene in both packages.
    Returns (jax_scene, torch_scene, K_np)."""
    K_np = intrinsics(h, w)
    rgb, depth = box_room_frame(np.eye(4), K_np, h, w, clutter=clutter)
    pts = camera.depth_to_points(jnp.asarray(depth), jnp.asarray(K_np))
    scene_j = scene_from_point_cloud(
        pts, jnp.asarray(rgb.reshape(-1, 3)), grid_shape=(h, w))
    scene_t = scene_from_numpy(
        {k: np.asarray(getattr(scene_j, k)) for k in scene_j._fields},
        device=CPU)
    return scene_j, scene_t, K_np


def perturbed_c2w(angles_deg=(0.06, -0.04, 0.03),
                  trans=(0.005, -0.004, 0.006)):
    from scipy.spatial.transform import Rotation

    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = Rotation.from_euler("xyz", angles_deg,
                                      degrees=True).as_matrix()
    c2w[:3, 3] = trans
    return c2w


def assert_rel(actual, desired, rtol, what=""):
    """max |a - d| <= rtol * max(|d|, tiny): relative to the array scale."""
    a, d = to_np(actual).astype(np.float64), to_np(desired).astype(np.float64)
    assert a.shape == d.shape, (what, a.shape, d.shape)
    scale = max(float(np.abs(d).max()) if d.size else 0.0, 1e-30)
    err = float(np.abs(a - d).max()) if d.size else 0.0
    assert err <= rtol * scale, (what, err, scale, err / scale)
