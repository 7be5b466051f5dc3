"""The frozen bound arithmetic gives chip_smoke.py's numbers on a fixed
input: a small box-room frame's K-cover slot buffer, cover buffer and
camera on the CPU."""

import numpy as np
import pytest
import torch

import bounds

NEAR, FAR = 1e-2, 1e10
H, W = 64, 128


@pytest.fixture(scope="module")
def step_inputs():
    from gsplatloc_tpu_torch.data.synthetic import box_room_frame
    from gsplatloc_tpu_torch.models.gaussians import scene_from_point_cloud
    from gsplatloc_tpu_torch.ops import kcover as kc
    from gsplatloc_tpu_torch.ops.camera import depth_to_points
    from gsplatloc_tpu_torch.ops.fused_tracking import cam_vector

    K = np.array([[64.0, 0, W / 2 - 0.5], [0, 64.0, H / 2 - 0.5], [0, 0, 1]],
                 np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -1.0
    _rgb, depth = box_room_frame(c2w, K, H, W, clutter=20)
    Kt = torch.from_numpy(K)
    pts = depth_to_points(torch.from_numpy(depth), Kt)
    pts = pts + torch.from_numpy(c2w[:3, 3])
    scene = scene_from_point_cloud(pts, torch.zeros_like(pts),
                                   grid_shape=(H, W), device="cpu")
    vm = torch.linalg.inv(torch.from_numpy(c2w))
    slot3d, meta, _ = kc.build_kcover_slot_buffer(scene, vm, Kt, W, H, NEAR,
                                                  FAR)
    cam = cam_vector(vm, Kt, W, H)
    kb = kc.build_kcover_buffer(slot3d, meta, cam, -(-H // 16),
                                -(-W // 128), NEAR, FAR, k_cover=16)
    return slot3d, meta, cam, kb


def test_peaks_and_bound():
    import chip_smoke

    assert bounds.PEAK_BYTES_PER_S == chip_smoke.PEAK_BYTES_PER_S
    assert bounds.PEAK_F32_OPS_PER_S == chip_smoke.PEAK_F32_OPS_PER_S
    for name in ("OPS_PROJECT", "OPS_COEFF", "OPS_ALPHA_DIRECT",
                 "OPS_PAIR_SELECT", "OPS_CHAIN"):
        assert getattr(bounds, name) == getattr(chip_smoke, name)
    for b, o in [(1e9, 1e6), (1e3, 1e12), (5e8, 3.3e11)]:
        assert bounds.bound(b, o) == chip_smoke.bound(b, o)[0]


def test_step_bounds(step_inputs):
    import chip_smoke

    _s, _m, cam, kb = step_inputs
    n_ty, n_tx = -(-H // 16), -(-W // 128)
    b1, b2, needed = chip_smoke.step_bounds(kb, cam, n_ty, n_tx)
    assert needed > 0
    assert bounds.step_bounds(kb, cam, n_ty, n_tx, NEAR, FAR) == (
        b1[0], b2[0])


def test_select_bound(step_inputs):
    import chip_smoke
    from gsplatloc_tpu_torch.ops import fused_subtile as fs
    from gsplatloc_tpu_torch.ops import kcover as kc

    slot3d, meta, cam, kb = step_inputs
    n_ty, n_tx = -(-H // 16), -(-W // 128)
    stats = {}
    kc._select_records_plain(slot3d, meta, cam, n_ty, n_tx, 16, NEAR, FAR,
                             stats=stats)
    p8 = fs.project8(slot3d, cam, NEAR, FAR)
    cull = chip_smoke.subtile_box_check(p8, meta, stats["seg_slots"], n_tx)
    want = chip_smoke.bound(
        stats["slots"] * 5 * 4 + kb.numel() * 4 + meta.numel() * 4,
        cull["box_pairs"] * chip_smoke.OPS_PAIR_SELECT
        + stats["slots"] * (chip_smoke.OPS_PROJECT + chip_smoke.OPS_COEFF))
    got = bounds.select_bound(slot3d, meta, cam, n_ty, n_tx, 16, NEAR, FAR)
    assert got == want[0]
    assert got > 0
