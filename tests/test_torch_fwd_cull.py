"""The walk of the forward tile kernels K6a (csrc/rasterize_fwd.cu) and K7a
(csrc/fused_tracking.cu fused_fwd), held where no kernel can run: a plain
emulation of their rules must give the images and the per-tile chunk
counts of the plain versions `_composite_fwd_plain` and `_fused_fwd_plain`
bit for bit. The rules: each warp of a tile holds a 32x8 pixel rectangle
and walks the tile's segment in depth order on its own, only the slots
whose footprint box (`_footprint_box`) meets its rectangle (`box_warps`'s
bit arithmetic), and in those only the pixels inside the box, skipping a
dead pixel and a zero alpha; it stops at the first 128-slot chunk boundary
at which none of its 256 pixels is alive, and the tile's `chunks_done` is
the largest of the 8 warps' stops. The scenes: the footprint cases of
test_torch_footprint.py, a full-tile slot buffer at a displaced pose, and
tiles whose warps die at different chunks."""

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
from torch_port_helpers import intrinsics, perturbed_c2w

NEAR, FAR = 1e-2, 1e10
N_WARPS = 8
COL = torch.arange(rt.P) % TILE_W
ROW = torch.arange(rt.P) // TILE_W
WARP_OF_PIXEL = (ROW // 8) * 4 + COL // 32  # (P,)


def _box_warps(c_lo, c_hi, r_lo, r_hi):
    """(..., 8) the warps whose rectangle each box meets, by the kernel's
    bit arithmetic (csrc/rasterize.cuh box_warps)."""
    empty = (c_lo > c_hi) | (r_lo > r_hi)
    c_lo, c_hi = c_lo.clamp(0, TILE_W - 1), c_hi.clamp(0, TILE_W - 1)
    bands = (2 << (c_hi >> 5)) - (1 << (c_lo >> 5))
    bits = (torch.where(r_lo < 8, bands, 0)
            | torch.where(r_hi >= 8, bands << 4, 0))
    bits = torch.where(empty, 0, bits)
    return ((bits[..., None] >> torch.arange(N_WARPS)) & 1).bool()


def _emulated_walk(chunk, meta, n_ty, n_tx):
    """The redesigned forward walk over every tile. chunk(col0, starts,
    ends, px, py) gives one 128-slot chunk of n tiles as the plain version
    evaluates it: the gated alpha (n, C, P), the in-segment mask (n, C),
    the six box fields (mx, my, ca, cb, cc, opacity; (n, C) each) and the
    payload channels (k, n, C). Returns (out (k, hp, wp), chunks_done
    (n_tiles,) int32, the warps' stops (n_tiles, 8))."""
    n_tiles = n_ty * n_tx
    starts, ends, base, n_chunks = rt._tile_bounds(meta, n_tiles)
    px, py = rt._pixel_xy(n_ty, n_tx, meta[0].long(), "cpu")
    tile = torch.arange(n_tiles)
    x0 = (tile % n_tx).float() * TILE_W
    y0 = (tile // n_tx + meta[0].long()).float() * TILE_H
    t = torch.ones((n_tiles, rt.P))
    acc = None
    stop = torch.full((n_tiles, N_WARPS), -1, dtype=torch.int64)
    for c in range(int(n_chunks.max()) + 1 if n_tiles else 0):
        alive = torch.zeros((n_tiles, N_WARPS)).index_add_(
            1, WARP_OF_PIXEL, (t > rt.T_EPS).float()) > 0
        # a warp stops at the first chunk boundary with no live pixel (or
        # at the end of its segment's chunks)
        ending = (stop < 0) & (~alive | (c >= n_chunks)[:, None])
        stop[ending] = c
        walking = stop < 0
        act = torch.nonzero(walking.any(dim=1))[:, 0]
        if act.numel() == 0:
            break
        alpha, in_seg, fields, chan = chunk(
            base[act] + c * rt.CHUNK, starts[act], ends[act], px[act],
            py[act])
        if acc is None:
            acc = torch.zeros((chan.shape[0], n_tiles, rt.P))
        c_lo, c_hi, r_lo, r_hi = rt._footprint_box(
            *fields, x0[act][:, None], y0[act][:, None])
        # the slots each warp walks: in the segment, its box meets the warp
        met = (_box_warps(c_lo, c_hi, r_lo, r_hi) & in_seg[..., None]
               & walking[act][:, None, :])  # (n, C, 8)
        # the pixels whose alpha the warp evaluates: inside the box
        visit = (met[:, :, WARP_OF_PIXEL]
                 & (COL >= c_lo[..., None]) & (COL <= c_hi[..., None])
                 & (ROW >= r_lo[..., None]) & (ROW <= r_hi[..., None]))
        ta, aa = t[act], acc[:, act]
        for jj in range(rt.CHUNK):
            a = torch.where(visit[:, jj], alpha[:, jj], 0.0)
            step = visit[:, jj] & (ta > rt.T_EPS) & (a != 0.0)
            t_incl = ta * (1.0 - a)
            w = torch.where(t_incl > rt.T_EPS, ta * a, 0.0)
            aa = torch.where(step, aa + chan[:, :, jj, None] * w, aa)
            ta = torch.where(step, t_incl, ta)
        t[act], acc[:, act] = ta, aa
    return (rt._from_tiles(acc, n_ty, n_tx), stop.max(dim=1).values.int(),
            stop)


def _records_chunk(records):
    """The general walk's chunk: record fields 0-4 and 6 for the box,
    payload [r, g, b, depth, 1]."""
    def chunk(col0, starts, ends, px, py):
        alpha, _dx, _dy, in_seg, rec = rt._chunk_alpha(
            records, col0, starts, ends, px, py)
        chan = torch.stack([rec[7], rec[8], rec[9], rec[5],
                            torch.ones_like(rec[5])])
        return alpha, in_seg, (rec[0], rec[1], rec[2], rec[3], rec[4],
                               rec[6]), chan
    return chunk


def _slots_chunk(slot3d, cam):
    """The full-tile walk's chunk: the projected rows with the opacity
    folded with ok for the box (as the kernel stages them), payload
    [qz, 1]."""
    def chunk(col0, starts, ends, px, py):
        alpha, _dx, _dy, in_seg, _pr, p8 = ft._fused_chunk(
            slot3d, cam, col0, starts, ends, px, py, NEAR, FAR)
        opa = torch.where(p8[7] != 0.0, p8[6], 0.0)
        chan = torch.stack([p8[5], torch.ones_like(p8[5])])
        return alpha, in_seg, (p8[0], p8[1], p8[2], p8[3], p8[4], opa), chan
    return chunk


def _assert_same(emulated, plain):
    out_e, cd_e, stop = emulated
    out_p, cd_p = plain
    assert torch.equal(cd_e, cd_p), (cd_e, cd_p)
    assert torch.equal(out_e, out_p), float((out_e - out_p).abs().max())
    assert float(out_p[-1].max()) > 0.0  # something was composited
    return stop


@pytest.mark.parametrize("case", list(CASES))
def test_culled_warp_walk_equals_the_plain_composite(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    records, meta, n_ty, n_tx = CASES[case](rng)
    if case == "opacity_zero":
        # nothing to composite: both walks give zero images
        out_p, cd_p = rt._composite_fwd_plain(records, meta, n_ty, n_tx)
        out_e, cd_e, _ = _emulated_walk(_records_chunk(records), meta, n_ty,
                                        n_tx)
        assert torch.equal(out_e, out_p) and torch.equal(cd_e, cd_p)
        assert not bool(out_p.any())
        return
    _assert_same(_emulated_walk(_records_chunk(records), meta, n_ty, n_tx),
                 rt._composite_fwd_plain(records, meta, n_ty, n_tx))


# Tiles whose warps die at different chunks: for warp w, 16 layers of 4
# splats (variance 16 px^2, centres 4 px inside its 32x8 rectangle, 8 px
# apart) take every pixel of the rectangle below T_EPS within chunk
# DEATH[w] and leave the far rows and columns of the other warps alive;
# faint small splats fill the rest of the 7 chunks.
DEATH = (0, 1, 1, 2, 3, 3, 4, 5)
N_CHUNKS_DYING = 7
LAYERS = 16


def _dying_warps(rng):
    """Per slot, in depth order: pixel centre (u, v) in a 128x16 tile,
    isotropic variance (px^2) and opacity."""
    n = N_CHUNKS_DYING * rt.CHUNK
    u = rng.uniform(0.0, TILE_W, n)
    v = rng.uniform(0.0, TILE_H, n)
    var = rng.uniform(0.5, 4.0, n)
    opa = rng.uniform(0.02, 0.2, n)
    for c in range(N_CHUNKS_DYING):
        killers = [w for w in range(N_WARPS) if DEATH[w] == c]
        slots = rng.choice(rt.CHUNK, 4 * LAYERS * len(killers), replace=False)
        for k, w in enumerate(killers):
            cols = 32 * (w % 4) + 4.0 + 8.0 * np.arange(4)
            take = np.sort(slots[k * 4 * LAYERS:(k + 1) * 4 * LAYERS])
            j = c * rt.CHUNK + take
            u[j] = np.tile(cols, LAYERS)
            v[j] = 8 * (w // 4) + 4.0
            var[j] = 16.0
            opa[j] = 0.99
    return u, v, var, opa


def _assert_warps_stop_apart(stop, n_chunks):
    stops = stop[0].tolist()
    assert len(set(stops)) >= 3, stops
    assert max(stops) < n_chunks, stops  # the tile's walk ended early


def test_culled_warp_walk_with_warps_dying_apart_general():
    u, v, var, opa = _dying_warps(np.random.default_rng(11))
    n = len(u)
    rec = np.zeros((rt.NUM_REC_ROWS, n), np.float32)
    rec[0], rec[1] = u, v
    rec[2] = rec[4] = 1.0 / var
    rec[5] = np.random.default_rng(12).uniform(1.0, 3.0, n)
    rec[6] = opa
    rec[7:10] = np.random.default_rng(13).uniform(0.0, 1.0, (3, n))
    records = torch.from_numpy(rec)
    meta = torch.tensor([0, 0, n], dtype=torch.int32)
    stop = _assert_same(
        _emulated_walk(_records_chunk(records), meta, 1, 1),
        rt._composite_fwd_plain(records, meta, 1, 1))
    # every warp stops right after the chunk that kills it
    assert stop[0].tolist() == [d + 1 for d in DEATH]
    _assert_warps_stop_apart(stop, N_CHUNKS_DYING)


def test_culled_warp_walk_with_warps_dying_apart_fulltile():
    """The same tile as 3D splats at depth 2 seen by an identity camera
    (f = 256 px, so the projected variance is 128^2 s2 + 0.3, within a
    few % of the general case's)."""
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
    slot3d = torch.from_numpy(slot)
    cam = ft.cam_vector(torch.eye(4), K, TILE_W, TILE_H)
    meta = torch.tensor([0, 0, n], dtype=torch.int32)
    stop = _assert_same(
        _emulated_walk(_slots_chunk(slot3d, cam), meta, 1, 1),
        ft._fused_fwd_plain(slot3d, meta, cam, 1, 1, NEAR, FAR))
    _assert_warps_stop_apart(stop, N_CHUNKS_DYING)


def test_culled_warp_walk_equals_the_plain_fused_forward():
    """A box-room slot buffer built at a displaced pose (the footprint
    test's `projected_fulltile` scene), rendered at that pose."""
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
    n_ty, n_tx = b.n_tiles_y, b.n_tiles_x
    _assert_same(_emulated_walk(_slots_chunk(slot, cam), meta, n_ty, n_tx),
                 ft._fused_fwd_plain(slot, meta, cam, n_ty, n_tx, NEAR, FAR))
