"""The K-cover path's staged step (opt/tracking.py:_KcoverSteps), run
eagerly on its fixed tensors as the CPU runs it, held bit for bit against
the autograd step (`_pose_step` through the K-cover render) over every
launched step of a tiny pair: masked steps, segment boundaries and
re-selections included. K1/K2 are looked up as ops.kcover's module
attributes once per launched step, on a cam no later stage rewrites. And
the two constant rows built on the device equal their former host-built
forms."""

import numpy as np
import pytest
import torch

from gsplatloc_tpu_torch.data.parser import render_depth_gt
from gsplatloc_tpu_torch.data.synthetic import box_room_frame
from gsplatloc_tpu_torch.models.gaussians import scene_from_point_cloud
from gsplatloc_tpu_torch.ops import kcover
from gsplatloc_tpu_torch.ops.camera import depth_to_points
from gsplatloc_tpu_torch.ops.fused_tracking import cam_vector
from gsplatloc_tpu_torch.ops.lie import construct_pose
from gsplatloc_tpu_torch.opt import tracking
from torch_port_helpers import intrinsics, perturbed_c2w

H, W = 48, 64
CONFIGS = {
    # a rebuild and a re-selection at every boundary, a tight select gate
    # that masks steps inside segments, early stop on
    "reselect": dict(max_steps=40, patience=20, warmup_steps=5,
                     resort_every=5, resort_motion_px=0.0,
                     select_motion_px=0.5, coast_after_steps=4),
    # no early stop, no coast mode (the gate factor is a plain 1.0), the
    # rebuild gated on motion
    "no_coast": dict(max_steps=36, warmup_steps=3, resort_every=6,
                     early_stop=False, coast_after_steps=0,
                     select_motion_px=0.3),
}


@pytest.fixture(scope="module")
def pair():
    K = intrinsics(H, W)
    rgb, depth = box_room_frame(np.eye(4), K, H, W, clutter=10)
    pts = depth_to_points(torch.as_tensor(depth, dtype=torch.float32),
                          torch.as_tensor(K))
    cols = torch.as_tensor(rgb.reshape(-1, 3), dtype=torch.float32)
    scene = scene_from_point_cloud(pts, cols, grid_shape=(H, W),
                                   device="cpu")
    depth_gt = render_depth_gt(pts, cols, K, perturbed_c2w(
        (0.7, -0.4, 0.3), (0.012, -0.01, 0.018)), H, W, grid_shape=(H, W),
        backend="subtile", device="cpu")
    return scene, K, depth_gt


def _track(pair, cfg, staged: bool) -> dict:
    """One pair through optimize_pose with recorders on the module
    attributes both steps call: every loss, every Adam update, and every
    K1 / K2 launch with its cam (and a copy taken at the call)."""
    scene, K, depth_gt = pair
    rec = {"loss": [], "adam": [], "fwd": [], "bwd": []}
    real_loss, real_adam = tracking.tracking_loss, tracking.adam_step
    real_fwd, real_bwd = kcover.kcover_step_fwd, kcover.kcover_step_bwd

    def loss(*a, **k):
        tl = real_loss(*a, **k)
        rec["loss"].append([t.detach().clone() for t in tl])
        return tl

    def adam(*a, **k):
        out = real_adam(*a, **k)
        rec["adam"].append([out[0].clone(), *(t.clone() for t in out[1])])
        return out

    def fwd(kbuf, cam, *a, **k):
        rec["fwd"].append((cam, cam.clone()))
        return real_fwd(kbuf, cam, *a, **k)

    def bwd(kbuf, cam, *a, **k):
        rec["bwd"].append(cam)
        return real_bwd(kbuf, cam, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracking, "tracking_loss", loss)
        mp.setattr(tracking, "adam_step", adam)
        mp.setattr(kcover, "kcover_step_fwd", fwd)
        mp.setattr(kcover, "kcover_step_bwd", bwd)
        if not staged:  # the autograd step on the K-cover render
            mp.setattr(tracking, "_kcover_steps", lambda *a: None)
        rec["res"] = tracking.optimize_pose(
            scene, np.eye(4, dtype=np.float32), depth_gt, K, W, H,
            config=tracking.TrackingConfig(**cfg), backend="fused",
            device="cpu")
    return rec


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request, pair):
    cfg = CONFIGS[request.param]
    return _track(pair, cfg, True), _track(pair, cfg, False)


def _equal_lists(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        for s, t in zip(x, y):
            assert torch.equal(s, t), i


def test_staged_step_is_bit_equal_to_the_autograd_step(runs):
    st, ag = runs
    a, b = st["res"], ag["res"]
    # the walk: masked steps, a boundary that re-selected
    assert a.launched >= 30 and a.launched > a.steps_run
    assert a.selects >= 1 and a.segments >= 2
    for name in ("steps_run", "rebuilds", "selects", "slot_overflow",
                 "launched", "segments"):
        assert getattr(a, name) == getattr(b, name), name
    # every launched step's three losses and both Adam updates
    assert len(st["loss"]) == a.launched
    _equal_lists(st["loss"], ag["loss"])
    assert len(st["adam"]) == 2 * a.launched
    _equal_lists(st["adam"], ag["adam"])
    for name in ("best_pose", "final_pose"):
        for x, y in zip(getattr(a, name), getattr(b, name)):
            assert torch.equal(x, y), name
    for name in ("best_loss", "best_depth_loss", "best_silhouette_loss"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    # the CPU runs the stages eagerly: no replay
    assert a.replayed == 0 and b.replayed == 0


def test_k1_and_k2_launch_once_per_launched_step(runs):
    st, _ag = runs
    n = st["res"].launched
    assert len(st["fwd"]) == len(st["bwd"]) == n
    # K2 takes the very cam K1 took
    assert all(c2 is c1 for (c1, _), c2 in zip(st["fwd"], st["bwd"]))


def test_the_cam_handed_to_k1_keeps_its_value(runs):
    st, _ag = runs
    cams = st["fwd"]
    assert all(torch.equal(cam, at_call) for cam, at_call in cams)
    # each step's own tensor: no two launches share one
    assert len({id(cam) for cam, _ in cams}) == len(cams)


def _construct_pose_host(rotation, translation):
    """construct_pose with its [0, 0, 0, 1] row made from a host list."""
    batch = rotation.shape[:-2]
    top = torch.cat([rotation, translation[..., None]], dim=-1)
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=rotation.dtype, device=rotation.device
    ).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def _cam_vector_host(viewmat, K, width, height):
    """cam_vector with its [width, height] made from a host list."""
    return torch.cat([
        torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]),
        viewmat[:3, :3].reshape(-1),
        viewmat[:3, 3],
        torch.tensor([float(width), float(height)], dtype=torch.float32,
                     device=viewmat.device),
    ]).to(torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [(), (3,), (2, 5)])
def test_construct_pose_matches_its_host_built_form(dtype, batch):
    g = torch.Generator().manual_seed(5)
    r = torch.randn(batch + (3, 3), generator=g, dtype=dtype)
    t = torch.randn(batch + (3,), generator=g, dtype=dtype)
    new, old = construct_pose(r, t), _construct_pose_host(r, t)
    assert new.dtype == old.dtype and new.shape == old.shape
    assert torch.equal(new, old)


@pytest.mark.parametrize("wh", [(64, 48), (1200, 680), (624, 464)])
def test_cam_vector_matches_its_host_built_form(wh):
    g = torch.Generator().manual_seed(6)
    vm = torch.randn(4, 4, generator=g).requires_grad_(True)
    K = torch.as_tensor(intrinsics(wh[1], wh[0]), dtype=torch.float32)
    new, old = cam_vector(vm, K, *wh), _cam_vector_host(vm, K, *wh)
    assert new.dtype == old.dtype == torch.float32
    assert torch.equal(new, old)
    # and the same gradient back to the viewmat
    d = torch.randn(18, generator=g)
    g_new, = torch.autograd.grad(new, vm, d)
    g_old, = torch.autograd.grad(old, vm, d)
    assert torch.equal(g_new, g_old)
