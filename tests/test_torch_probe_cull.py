"""The walk of the full-tile probe K7c (csrc/fused_tracking.cu
fused_walk_kernel<true>), held where no kernel can run: a plain emulation
of its rules must give the contribution flags and the per-tile chunk
counts of the plain version `_fused_probe_plain` bit for bit. The rules
are the forward's (test_torch_fwd_cull.py): each warp of a tile holds a
32x8 pixel rectangle and walks the tile's segment in depth order on its
own, only the slots whose footprint box (`_footprint_box`) meets its
rectangle and in those only the pixels inside the box, skipping a dead
pixel and a zero alpha; it stops at the first 128-slot chunk boundary at
which none of its 256 pixels is alive, and the tile's `chunks_done` is the
largest of the 8 warps' stops. A slot's flag is the OR, over the warps
that walked it, of the pixels it reached (alpha != 0 at a live T); a
flagged slot's column gets 1.0 and every other column keeps the zero
fill. The scenes: the footprint cases of test_torch_footprint.py, the
displaced full-tile slot buffer of test_torch_fwd_cull.py, and tiles
whose warps die at different chunks. The footprint cases are 2D records,
which `_fused_probe_plain` (3D slots and a camera) cannot take: there the
reference is `_fused_probe_plain`'s block-synchronous rule applied to the
general walk's chunks (`_probe_reference`), which every full-tile scene
holds bit-equal to `_fused_probe_plain` itself."""

import numpy as np
import pytest
import torch

from gsplatloc_tpu_torch.data.synthetic import box_room_frame
from gsplatloc_tpu_torch.models.gaussians import scene_from_point_cloud
from gsplatloc_tpu_torch.ops import fused_tracking as ft
from gsplatloc_tpu_torch.ops import rasterize_tiles as rt
from gsplatloc_tpu_torch.ops.binning import TILE_H, TILE_W
from gsplatloc_tpu_torch.ops.camera import depth_to_points
from gsplatloc_tpu_torch.ops.lie import invert_se3
from test_torch_footprint import CASES
from test_torch_fwd_cull import (COL, DEATH, FAR, N_CHUNKS_DYING, N_WARPS,
                                 NEAR, ROW, WARP_OF_PIXEL, _box_warps,
                                 _dying_warps, _records_chunk, _slots_chunk)
from torch_port_helpers import intrinsics, perturbed_c2w


def _emulated_probe(chunk, meta, n_ty, n_tx, m_pad):
    """The redesigned probe walk over every tile. chunk(col0, starts, ends,
    px, py) gives one 128-slot chunk of n tiles as in
    test_torch_fwd_cull.py's `_emulated_walk`. Returns (contrib (m_pad,),
    chunks_done (n_tiles,) int32, the warps' stops (n_tiles, 8))."""
    n_tiles = n_ty * n_tx
    starts, ends, base, n_chunks = rt._tile_bounds(meta, n_tiles)
    px, py = rt._pixel_xy(n_ty, n_tx, meta[0].long(), "cpu")
    tile = torch.arange(n_tiles)
    x0 = (tile % n_tx).float() * TILE_W
    y0 = (tile // n_tx + meta[0].long()).float() * TILE_H
    t = torch.ones((n_tiles, rt.P))
    contrib = torch.zeros((m_pad,))
    stop = torch.full((n_tiles, N_WARPS), -1, dtype=torch.int64)
    for c in range(int(n_chunks.max()) + 1 if n_tiles else 0):
        alive = torch.zeros((n_tiles, N_WARPS)).index_add_(
            1, WARP_OF_PIXEL, (t > rt.T_EPS).float()) > 0
        ending = (stop < 0) & (~alive | (c >= n_chunks)[:, None])
        stop[ending] = c
        walking = stop < 0
        act = torch.nonzero(walking.any(dim=1))[:, 0]
        if act.numel() == 0:
            break
        col0 = base[act] + c * rt.CHUNK
        alpha, in_seg, fields, _chan = chunk(col0, starts[act], ends[act],
                                             px[act], py[act])
        c_lo, c_hi, r_lo, r_hi = rt._footprint_box(
            *fields, x0[act][:, None], y0[act][:, None])
        met = (_box_warps(c_lo, c_hi, r_lo, r_hi) & in_seg[..., None]
               & walking[act][:, None, :])  # (n, C, 8)
        visit = (met[:, :, WARP_OF_PIXEL]
                 & (COL >= c_lo[..., None]) & (COL <= c_hi[..., None])
                 & (ROW >= r_lo[..., None]) & (ROW <= r_hi[..., None]))
        ta = t[act]
        # per slot, the warps whose lanes reached it (each warp's OR)
        reached = torch.zeros(met.shape, dtype=torch.bool)
        for jj in range(rt.CHUNK):
            a = torch.where(visit[:, jj], alpha[:, jj], 0.0)
            step = visit[:, jj] & (ta > rt.T_EPS) & (a != 0.0)
            reached[:, jj] = torch.zeros((len(act), N_WARPS)).index_add_(
                1, WARP_OF_PIXEL, step.float()) > 0
            ta = torch.where(step, ta * (1.0 - a), ta)
        t[act] = ta
        # the lane that staged a slot some warp reached writes 1.0
        flag = reached.any(dim=2)
        idx = col0[:, None] + torch.arange(rt.CHUNK)
        contrib[idx[flag]] = 1.0
    return contrib, stop.max(dim=1).values.int(), stop


def _probe_reference(chunk, meta, n_ty, n_tx, m_pad):
    """`_fused_probe_plain`'s rule on any chunk function: chunk by chunk,
    the tiles still alive at the chunk's entry walk all of it over all
    their pixels, a slot marked iff it has alpha > 0 at a pixel whose
    T_prefix > T_EPS."""
    n_tiles = n_ty * n_tx
    starts, ends, base, n_chunks = rt._tile_bounds(meta, n_tiles)
    px, py = rt._pixel_xy(n_ty, n_tx, meta[0].long(), "cpu")
    t = torch.ones((n_tiles, rt.P))
    contrib = torch.zeros((m_pad,))
    cd = torch.zeros((n_tiles,), dtype=torch.int32)
    for c in range(int(n_chunks.max()) if n_tiles else 0):
        act = ft._live_tiles(t, c, n_chunks)
        if act.numel() == 0:
            break
        cd[act] += 1
        col0 = base[act] + c * rt.CHUNK
        alpha, in_seg, _fields, _chan = chunk(col0, starts[act], ends[act],
                                              px[act], py[act])
        ta = t[act]
        one_minus = 1.0 - alpha
        reach = torch.empty(in_seg.shape, dtype=torch.bool)
        for jj in range(rt.CHUNK):
            reach[:, jj] = ((alpha[:, jj] > 0.0) & (ta > rt.T_EPS)).any(dim=1)
            ta = ta * one_minus[:, jj]
        t[act] = ta
        idx = col0[:, None] + torch.arange(rt.CHUNK)
        contrib[idx[in_seg]] = reach[in_seg].float()
    return contrib, cd


def _assert_same(emulated, plain):
    c_e, cd_e, stop = emulated
    c_p, cd_p = plain
    assert torch.equal(cd_e, cd_p), (cd_e, cd_p)
    assert torch.equal(c_e, c_p), int((c_e != c_p).sum())
    return stop


@pytest.mark.parametrize("case", list(CASES))
def test_culled_probe_equals_the_plain_probe(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    records, meta, n_ty, n_tx = CASES[case](rng)
    m_pad = records.shape[1]
    chunk = _records_chunk(records)
    ref = _probe_reference(chunk, meta, n_ty, n_tx, m_pad)
    _assert_same(_emulated_probe(chunk, meta, n_ty, n_tx, m_pad), ref)
    if case == "opacity_zero":
        assert not bool(ref[0].any())  # nothing reaches a pixel
    else:
        # some slots reach a pixel and, where the walk met them, some not
        assert 0 < int(ref[0].sum()) < int(meta[-1] - meta[1])


def _fulltile(slot3d, cam, meta, n_ty, n_tx):
    """Emulation, generic reference and `_fused_probe_plain` on one
    full-tile scene, all bit-equal; chunks_done also the forward's."""
    m_pad = slot3d.shape[1]
    chunk = _slots_chunk(slot3d, cam)
    plain = ft._fused_probe_plain(slot3d, meta, cam, n_ty, n_tx, NEAR, FAR)
    ref = _probe_reference(chunk, meta, n_ty, n_tx, m_pad)
    assert torch.equal(ref[0], plain[0]) and torch.equal(ref[1], plain[1])
    emulated = _emulated_probe(chunk, meta, n_ty, n_tx, m_pad)
    stop = _assert_same(emulated, plain)
    _out, cd_fwd = ft._fused_fwd_plain(slot3d, meta, cam, n_ty, n_tx, NEAR,
                                       FAR)
    assert torch.equal(plain[1], cd_fwd)
    return emulated, plain, stop


def test_culled_probe_with_warps_dying_apart_general():
    u, v, var, opa = _dying_warps(np.random.default_rng(11))
    n = len(u)
    rec = np.zeros((rt.NUM_REC_ROWS, n), np.float32)
    rec[0], rec[1] = u, v
    rec[2] = rec[4] = 1.0 / var
    rec[5] = np.random.default_rng(12).uniform(1.0, 3.0, n)
    rec[6] = opa
    records = torch.from_numpy(rec)
    meta = torch.tensor([0, 0, n], dtype=torch.int32)
    chunk = _records_chunk(records)
    stop = _assert_same(_emulated_probe(chunk, meta, 1, 1, n),
                        _probe_reference(chunk, meta, 1, 1, n))
    assert stop[0].tolist() == [d + 1 for d in DEATH]


def test_culled_probe_with_warps_dying_apart_fulltile():
    """test_torch_fwd_cull.py's dying tile as 3D splats at depth 2 seen by
    an identity camera."""
    u, v, var, opa = _dying_warps(np.random.default_rng(11))
    n = len(u)
    f, z = 256.0, 2.0
    K = torch.tensor([[f, 0.0, TILE_W / 2 - 0.5], [0.0, f, TILE_H / 2 - 0.5],
                      [0.0, 0.0, 1.0]])
    slot = np.zeros((ft.NUM_ISO_ROWS, n), np.float32)
    slot[0] = (u - (TILE_W / 2 - 0.5)) * z / f
    slot[1] = (v - (TILE_H / 2 - 0.5)) * z / f
    slot[2] = z
    slot[3] = (var - ft.EPS2D) * (z / f) ** 2
    slot[4] = opa
    cam = ft.cam_vector(torch.eye(4), K, TILE_W, TILE_H)
    meta = torch.tensor([0, 0, n], dtype=torch.int32)
    _e, (contrib, cd), stop = _fulltile(torch.from_numpy(slot), cam, meta,
                                        1, 1)
    stops = stop[0].tolist()
    assert len(set(stops)) >= 3 and max(stops) < N_CHUNKS_DYING, stops
    # slots behind the dead rectangles still reach the live pixels
    assert 0 < int(contrib.sum()) < n and int(cd[0]) == max(stops)


def test_culled_probe_on_the_displaced_fulltile_buffer_compacts_alike():
    """The box-room slot buffer built at a displaced pose (the footprint
    test's `projected_fulltile` scene), probed at that pose; the
    compaction it drives is the same from either flag vector."""
    h, w = 48, 256
    K = torch.as_tensor(intrinsics(h, w))
    rgb, depth = box_room_frame(np.eye(4), K.numpy(), h, w, clutter=10)
    scene = scene_from_point_cloud(
        depth_to_points(torch.as_tensor(depth), K),
        torch.as_tensor(rgb.reshape(-1, 3)), grid_shape=(h, w),
        knn_method="grid", device="cpu")
    vm = invert_se3(torch.as_tensor(perturbed_c2w((0.8, -0.6, 0.5),
                                                  (0.02, -0.01, 0.03))))
    slot, meta, b = ft.build_slot_buffer(scene, vm, K, w, h, NEAR, FAR)
    cam = ft.cam_vector(vm, K, w, h)
    (c_e, cd_e, _), (c_p, cd_p), _ = _fulltile(slot, cam, meta, b.n_tiles_y,
                                              b.n_tiles_x)
    kept = int(c_p.sum())
    assert 0 < kept < int(meta[-1] - meta[1])
    s_e, m_e = ft.compact_slot_buffer(slot, meta, c_e, cd_e)
    s_p, m_p = ft.compact_slot_buffer(slot, meta, c_p, cd_p)
    assert torch.equal(s_e, s_p) and torch.equal(m_e, m_p)
    assert int(m_p[-1] - m_p[1]) == kept
