"""The walks of the sub-tile forward K4b (csrc/subtile_fwd.cu) and of the
K-cover select K3 / K8 (csrc/kcover_select.cu, records and index form),
held where no kernel can run: plain emulations of their rules, in torch
with the kernels' operation order, must give the plain versions'
outputs bit for bit (`_subtile_fwd_plain`: out and chunks_done;
`_select_walk`: the records and the columns).

The rules, shared by both walks: one block per 16x16 sub-tile, warp w
holding pixel rows 2w and 2w+1; the block stages a round of slots (K4b a
128-slot chunk, the select 256 slots) with each slot's footprint box
(`_subtile_box`) as a column / row bit mask (csrc/subtile.cuh
sub_box_mask); each warp walks in slot order only the slots whose mask
meets its rows, in 32-slot groups, and in those evaluates only the lanes
whose pixel is inside the mask and still live (K4b: alive; the select:
not done). K4b skips a warp with no live pixel at the chunk's entry and
stops the block at the first chunk boundary with no live pixel; the
select skips a group when its warp's 32 pixels are all done and stops the
block after the first round in which every pixel is done. Slot buffers
come from the JAX package's `build_*_slot_buffer`, handed over as numpy;
one scene's plain select is also held against the JAX package's
`select_kcover_records`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplatloc_tpu.ops import kcover as jkc
from gsplatloc_tpu.ops.fused_tracking import cam_vector as j_cam_vector
from gsplatloc_tpu_torch.ops import fused_subtile as tfs
from gsplatloc_tpu_torch.ops import kcover as tkc
from gsplatloc_tpu_torch.ops.fused_tracking import (
    _project8_rows, _project_slots, cam_vector,
)
from test_torch_subtile_cull import NAMES, _cloud, _pixels, _viewmat, case
from torch_port_helpers import box_scene, to_np, tt

NEAR, FAR = 1e-2, 1e10
N_WARPS = 8
F32 = torch.float32
ROW, COL, _, _ = _pixels()
WARP_OF = ROW // 2
SEL_STAGE = tfs.P_SUB  # slots the select stages per round


def _masks(c_lo, c_hi, r_lo, r_hi):
    """The boxes as the kernels' words (csrc/subtile.cuh sub_box_mask):
    bits 0-15 the columns, 16-31 the rows; 0 for an empty box."""
    empty = (c_lo > c_hi) | (r_lo > r_hi)
    one = torch.ones_like(c_lo)
    cols = (2 * (one << c_hi.clamp_min(0))) - (one << c_lo.clamp_max(15))
    rows = (2 * (one << r_hi.clamp_min(0))) - (one << r_lo.clamp_max(15))
    return torch.where(empty, 0, cols | (rows << 16))


def _meets(mask):
    """(..., 8) sub_mask_meets_warp of every warp."""
    w = torch.arange(N_WARPS)
    return ((mask[..., None] >> (16 + 2 * w)) & 3) != 0


def _holds(mask):
    """(..., P_SUB) sub_mask_holds of every pixel."""
    m = mask[..., None]
    return (((m >> COL) & (m >> (16 + ROW))) & 1) != 0


def _boxed_coef(p8, idx, x0, y0):
    """Coefficients (n, C, 8) and box masks (n, C) of the slots idx (n, C)
    against the origins x0, y0 (n,), as the kernels stage them."""
    n, c = idx.shape
    xa = x0[:, None].expand(n, c).reshape(1, -1)
    ya = y0[:, None].expand(n, c).reshape(1, -1)
    rec = p8[:, idx.reshape(-1)]
    coef = tfs._coeff_mat(rec, xa, ya)
    box = tfs._subtile_box(coef, rec[0] - xa[0], rec[1] - ya[0])
    return coef.reshape(n, c, 8), _masks(*box).reshape(n, c)


# ------------------------------------------------------------------ K4b

def fwd_culled(p8, meta, n_ty, n_tx):
    """The redesigned K4b walk. Returns (out (2, M_out), chunks_done
    (n_seg,) int32, evaluated (slot, pixel) pairs, the transmittance
    (n_seg, P_SUB))."""
    n_seg = n_ty * n_tx * tfs.N_SUB
    starts, ends = tfs._segment_bounds(meta, n_seg)
    seg_chunks = (ends - starts) // tfs.CHUNK
    x0, y0 = tfs._segment_origins(meta, n_seg, n_tx)
    mono = tfs._sub_mono("cpu")
    t = torch.ones((n_seg, tfs.P_SUB))
    dacc = torch.zeros_like(t)
    aacc = torch.zeros_like(t)
    cd = torch.zeros((n_seg,), dtype=torch.int32)
    n_eval = 0
    for c in range(int(seg_chunks.max()) if n_seg else 0):
        # the block vote at the chunk boundary
        act = torch.nonzero((t.max(dim=1).values > tfs.T_EPS)
                            & (c < seg_chunks))[:, 0]
        if act.numel() == 0:
            break
        cd[act] += 1
        idx = (starts[act][:, None] + c * tfs.CHUNK
               + torch.arange(tfs.CHUNK)[None, :])
        coef, mask = _boxed_coef(p8, idx, x0[act], y0[act])
        n = act.numel()
        alpha = tfs._sub_alpha(coef.reshape(-1, 8), mono).reshape(
            n, tfs.CHUNK, tfs.P_SUB)
        ta, da, aa = t[act], dacc[act], aacc[act]
        # a warp with no live pixel at the chunk's entry skips its lists
        warp_live = (ta > tfs.T_EPS).reshape(n, N_WARPS, 32).any(dim=2)
        met = _meets(mask) & warp_live[:, None, :]  # (n, C, 8)
        for j in range(tfs.CHUNK):
            ev = (met[:, j][:, WARP_OF] & _holds(mask[:, j])
                  & (ta > tfs.T_EPS))
            n_eval += int(ev.sum())
            a = alpha[:, j]
            t_incl = ta * (1.0 - a)
            w = torch.where(t_incl > tfs.T_EPS, ta * a, 0.0)
            da = torch.where(ev, da + coef[:, j, 6:7] * w, da)
            aa = torch.where(ev, aa + w, aa)
            ta = torch.where(ev, t_incl, ta)
        t[act], dacc[act], aacc[act] = ta, da, aa
    out = torch.stack([dacc.reshape(-1), aacc.reshape(-1)])
    return out, cd, n_eval, t


def _bits(x):
    return x.contiguous().view(torch.int32)


def _assert_fwd_equal(p8, meta, n_ty, n_tx):
    out_p, cd_p = tfs._subtile_fwd_plain(p8, meta, n_ty, n_tx)
    out_e, cd_e, n_eval, t = fwd_culled(p8, meta, n_ty, n_tx)
    assert torch.equal(cd_e, cd_p), (cd_e, cd_p)
    assert torch.equal(_bits(out_e), _bits(out_p)), float(
        (out_e - out_p).abs().max())
    assert float(out_p[1].max()) > 0.0  # something was composited
    return cd_p, n_eval, t


@pytest.mark.parametrize("name", NAMES)
def test_culled_forward_walk_equals_the_plain_forward(name):
    p8, meta, n_ty, n_tx, _, _ = case(name)
    cd, n_eval, _ = _assert_fwd_equal(p8, meta, n_ty, n_tx)
    walked = int(cd.sum()) * tfs.CHUNK
    # the cull evaluates a small part of what the unculled walk met
    assert 0 < n_eval < 0.25 * walked * tfs.P_SUB, (n_eval, walked)


def _dying_sub_tile():
    """One sub-tile: opaque flat splats over rows 0-3 in the first chunk,
    over rows 8-9 in the third, then faint wide slots over the whole
    sub-tile; rows 4-7 and 10-15 stay alive to the end."""
    m_pad = 8192
    n = 4 * tfs.CHUNK
    p8 = torch.zeros((8, m_pad))
    for k in range(8):  # two on each of rows 0-3
        p8[:, k] = torch.tensor([8.0, 0.5 + k // 2, 1e-4, 0.0, 20.0,
                                 1.0 + 1e-3 * k, 1.0, 1.0])
    for k in range(4):  # two on each of rows 8-9, in chunk 2
        j = 2 * tfs.CHUNK + 5 + k
        p8[:, j] = torch.tensor([8.0, 8.5 + k // 2, 1e-4, 0.0, 20.0,
                                 2.5 + 1e-3 * k, 1.0, 1.0])
    rng = np.random.default_rng(3)
    killers = range(2 * tfs.CHUNK + 5, 2 * tfs.CHUNK + 9)
    rest = [j for j in range(8, n) if j not in killers]
    m = len(rest)
    p8[0, rest] = torch.as_tensor(rng.uniform(0, 16, m).astype(np.float32))
    p8[1, rest] = torch.as_tensor(rng.uniform(0, 16, m).astype(np.float32))
    p8[2, rest] = 0.02
    p8[4, rest] = 0.02
    p8[5, rest] = torch.linspace(2.0, 3.0, m)
    p8[6, rest] = 0.01
    p8[7, rest] = 1.0
    meta = torch.zeros(10, dtype=torch.int32)
    meta[2:] = n
    return p8, meta


def test_culled_forward_walk_with_warps_dying_apart():
    """Warps 0-1 die in the first chunk and warp 4 in the third; their
    lists are skipped from then on, while the others walk all four
    chunks: out and chunks_done bit-equal to the plain forward."""
    p8, meta = _dying_sub_tile()
    cd, _, t = _assert_fwd_equal(p8, meta, 1, 1)
    assert int(cd[0]) == 4
    warp_live = (t[0] > tfs.T_EPS).reshape(N_WARPS, 32).any(dim=1).tolist()
    assert warp_live == [False, False, True, True, False, True, True, True]


# --------------------------------------------------------------- select

def select_culled(p8, rows, fill, meta, n_ty, n_tx, k_cover):
    """The redesigned select walk, both forms: the columns of `rows` (R,
    B_pad) of each pixel's first K hits, `fill` behind the last. Returns
    ((R, K, M_out), evaluated (slot, pixel) pairs, per-pixel hit counts
    (n_seg, P_SUB), per-pixel death (n_seg, P_SUB) bool)."""
    n_seg = n_ty * n_tx * tfs.N_SUB
    m_out = n_seg * tfs.P_SUB
    b_pad = p8.shape[1]
    n_rows = rows.shape[0]
    starts, ends = tfs._segment_bounds(meta, n_seg)
    seg_len = ends - starts
    x0, y0 = tfs._segment_origins(meta, n_seg, n_tx)
    mono = tfs._sub_mono("cpu")
    out = torch.full((n_seg, k_cover, n_rows, tfs.P_SUB), fill)
    t = torch.ones((n_seg, tfs.P_SUB))
    cnt = torch.zeros((n_seg, tfs.P_SUB), dtype=torch.int64)
    done = torch.zeros((n_seg, tfs.P_SUB), dtype=torch.bool)
    running = seg_len > 0
    n_eval = 0
    for base in range(0, int(seg_len.max()) if n_seg else 0, SEL_STAGE):
        act = torch.nonzero(running & (base < seg_len))[:, 0]
        if act.numel() == 0:
            break
        n = act.numel()
        idx = starts[act][:, None] + base + torch.arange(SEL_STAGE)[None, :]
        valid = idx < ends[act][:, None]
        idx = idx.clamp_max(b_pad - 1)
        coef, mask = _boxed_coef(p8, idx, x0[act], y0[act])
        mask = torch.where(valid, mask, 0)
        alpha = tfs._sub_alpha(coef.reshape(-1, 8), mono).reshape(
            n, SEL_STAGE, tfs.P_SUB)
        meets = _meets(mask)  # (n, 256, 8)
        ta, ca, da, oa = t[act], cnt[act], done[act], out[act]
        for j in range(SEL_STAGE):
            if j % 32 == 0:
                # a warp whose 32 pixels are all done skips the group
                warp_busy = (~da).reshape(n, N_WARPS, 32).any(dim=2)
            ev = ((meets[:, j] & warp_busy)[:, WARP_OF]
                  & _holds(mask[:, j]) & ~da)
            n_eval += int(ev.sum())
            a = alpha[:, j]
            hit = ev & (a > 0.0)
            rec = rows[:, idx[:, j]].T  # (n, R)
            slot = ca.clamp_max(k_cover - 1)[:, None, None, :].expand(
                n, 1, n_rows, tfs.P_SUB)
            cur = oa.gather(1, slot)
            oa.scatter_(1, slot, torch.where(
                hit[:, None, None, :], rec[:, None, :, None].expand_as(cur),
                cur))
            ca = ca + hit.to(torch.int64)
            ta = torch.where(hit, ta * (1.0 - a), ta)
            da = da | (hit & ((ca >= k_cover) | ~(ta > tfs.T_EPS)))
        t[act], cnt[act], done[act], out[act] = ta, ca, da, oa
        # the block stops after the round in which every pixel is done
        running[act] = ~da.all(dim=1)
    res = out.permute(2, 1, 0, 3).reshape(n_rows, k_cover, m_out)
    return res, n_eval, cnt, done & (cnt < k_cover)


def _kcover_case(name):
    """(slot3d, meta, cam, n_ty, n_tx) of a K-cover slot buffer built by
    the reference, and the port's camera vector of a pose about a pixel
    off the build pose."""
    if name == "boxroom":
        h, w = 32, 64
        scene, _, K = box_scene(h, w)
        vm_b = jnp.eye(4)
        vm_r = _viewmat((0.3, -0.2, 0.25), (0.004, -0.003, 0.005))
    else:
        h, w = 32, 128
        scene = _cloud(1.0 if name == "cloud_opa1" else 0.55)
        from gsplatloc_tpu.ops import camera

        K = np.asarray(camera.intrinsics_matrix(70.0, 70.0, w / 2 - 0.5,
                                                h / 2 - 0.5))
        vm_b = _viewmat((1, -0.5, 0.8), (0.01, -0.015, 0.02))
        vm_r = _viewmat((1.1, -0.4, 0.7), (0.012, -0.013, 0.021))
    slot, meta, ovf = jkc.build_kcover_slot_buffer(
        scene, vm_b, jnp.asarray(K), w, h, NEAR, FAR)
    assert not bool(ovf)
    n_ty, n_tx = -(-h // 16), -(-w // 128)
    cam = cam_vector(tt(np.asarray(vm_r)), tt(np.asarray(K)), w, h)
    return (tt(np.asarray(slot)), tt(np.asarray(meta), torch.int32), cam,
            n_ty, n_tx)


_KCASES = {}


def kcase(name):
    if name not in _KCASES:
        _KCASES[name] = _kcover_case(name)
    return _KCASES[name]


def _assert_select_equal(p8, slot3d, meta, n_ty, n_tx, k_cover):
    """Both forms of the culled select bit-equal to `_select_walk`'s.
    Returns the hit counts and the pixels that died before K hits."""
    stats = {}
    rec_p = tkc._select_walk(p8, slot3d[:tkc.NREC_KC], 0.0, meta, n_ty,
                             n_tx, k_cover, stats=stats)
    rec_e, n_eval, cnt, died = select_culled(
        p8, slot3d[:tkc.NREC_KC], 0.0, meta, n_ty, n_tx, k_cover)
    assert torch.equal(_bits(rec_e), _bits(rec_p))
    m_pad = p8.shape[1]
    cols = torch.arange(m_pad, dtype=F32)[None, :]
    idx_p = tkc._select_index_plain(p8, meta, n_ty, n_tx, k_cover)
    idx_e, n_eval_i, _, _ = select_culled(p8, cols, float(m_pad), meta,
                                          n_ty, n_tx, k_cover)
    assert torch.equal(idx_e[0], idx_p)
    assert n_eval_i == n_eval
    assert int(stats["seg_slots"].sum()) == stats["slots"]
    return cnt, died, n_eval, stats


@pytest.mark.parametrize("k_cover", [16, 12])
@pytest.mark.parametrize("name", NAMES)
def test_culled_select_equals_the_plain_select(name, k_cover):
    slot3d, meta, cam, n_ty, n_tx = kcase(name)
    p8 = _project8_rows(_project_slots(slot3d, cam), NEAR, FAR)
    cnt, _, n_eval, stats = _assert_select_equal(p8, slot3d, meta, n_ty,
                                                 n_tx, k_cover)
    assert int(cnt.max()) >= 1
    # the cull evaluates a small part of what the unculled walk met
    assert 0 < n_eval < 0.25 * stats["pairs"], (n_eval, stats["pairs"])


def _select_sub_tile():
    """One sub-tile of 600 slots: four opaque flat splats, two on each of
    rows 0-1 (the pixels there die after two hits), then faint wide
    splats over the whole sub-tile (the other pixels fill their K
    entries)."""
    n = 600
    p8 = torch.zeros((8, 8192))
    for k in range(4):
        p8[:, k] = torch.tensor([8.0, 0.5 + k // 2, 1e-4, 0.0, 20.0,
                                 1.0 + 1e-3 * k, 1.0, 1.0])
    rng = np.random.default_rng(7)
    m = n - 4
    p8[0, 4:n] = torch.as_tensor(rng.uniform(0, 16, m).astype(np.float32))
    p8[1, 4:n] = torch.as_tensor(rng.uniform(0, 16, m).astype(np.float32))
    p8[2, 4:n] = 0.05
    p8[4, 4:n] = 0.05
    p8[5, 4:n] = torch.linspace(2.0, 3.0, m)
    p8[6, 4:n] = 0.05
    p8[7, 4:n] = 1.0
    slot3d = torch.as_tensor(rng.uniform(-1, 1, (8, 8192)).astype(np.float32))
    meta = torch.zeros(10, dtype=torch.int32)
    meta[2:] = n
    return p8, slot3d, meta


@pytest.mark.parametrize("k_cover", [16, 12])
def test_culled_select_fills_and_dies_on_a_hand_made_sub_tile(k_cover):
    """Pixels that fill their K entries, pixels that die before, and a
    block that stops before the end of its segment: both forms bit-equal
    to the plain select."""
    p8, slot3d, meta = _select_sub_tile()
    cnt, died, _, stats = _assert_select_equal(p8, slot3d, meta, 1, 1,
                                               k_cover)
    assert int((cnt == k_cover).sum()) > 0
    assert bool(died[0, :2 * tfs.SUB_W].all())
    assert int(cnt[0, :2 * tfs.SUB_W].max()) == 2
    assert 0 < stats["slots"] < SEL_STAGE  # every pixel done in round 0


def test_plain_select_live_records_equal_the_reference():
    """The plain select against the JAX package's select_kcover_records
    (Pallas, interpret mode) on the box room: every record the port admits
    is the reference's record at the same list position; the reference
    may hold extra tail records after a pixel's death (its liveness is
    gated per 256-slot block)."""
    slot3d, meta, _, n_ty, n_tx = kcase("boxroom")
    h, w = 32, 64
    K = np.asarray(box_scene(h, w)[2])
    # at the build pose (the identity) both packages project alike
    cam = cam_vector(torch.eye(4), tt(K), w, h)
    cam_j = j_cam_vector(jnp.eye(4), jnp.asarray(K), w, h)
    np.testing.assert_array_equal(to_np(cam), to_np(cam_j))
    k_cover = 16
    kb_j = to_np(jkc.select_kcover_records(
        jnp.asarray(to_np(slot3d)), jnp.asarray(to_np(meta)), cam_j, n_ty,
        n_tx, k_cover, NEAR, FAR))
    kb_t = to_np(tkc._select_records_plain(slot3d, meta, cam, n_ty, n_tx,
                                           k_cover, NEAR, FAR))
    assert kb_t.shape == kb_j.shape
    live = kb_t[4] > 0.0
    assert live.mean() > 0.1
    for r in range(tkc.NREC_KC):
        np.testing.assert_array_equal(kb_t[r][live], kb_j[r][live])
    assert not (live & ~(kb_j[4] > 0.0)).any()
