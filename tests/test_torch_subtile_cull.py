"""The footprint cull of the sub-tile backward walk (K5a, csrc/subtile_bwd.cu)
on the CPU, where no kernel runs: its box (`_subtile_box`, the plain form of
csrc/subtile.cuh subtile_box) holds every pair that passes `_sub_alpha`'s
gates, and the kernel's walk rules, emulated in torch with the kernel's
operation order, give moments bit-equal to an emulation of the unculled
walk it replaces.

The culled walk: warp w holds pixel rows 2w and 2w+1; it evaluates only the
slots whose box meets its rows and only the pixels inside the box, stops
evaluating at the first chunk boundary at which none of its pixels is
alive, and its partial moments join the others' in warp order, only for
the warps that met the slot. The unculled walk: every slot against every
pixel of the sub-tile while any pixel is alive, row sums over all 16
columns, the 8 warp partials added in order. Slot buffers come from the
JAX package's build_subtile_slot_buffer, handed over as numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gsplatloc_tpu.data.synthetic import random_gaussian_cloud
from gsplatloc_tpu.models.gaussians import scene_from_point_cloud
from gsplatloc_tpu.ops import camera
from gsplatloc_tpu.ops import fused_subtile as jfs
from gsplatloc_tpu.ops.lie import invert_se3
from gsplatloc_tpu_torch.ops import fused_subtile as tfs
from gsplatloc_tpu_torch.ops.fused_tracking import cam_vector
from torch_port_helpers import box_scene, tt

NEAR, FAR = 1e-2, 1e10
TOL_MOM_REL = 1e-5  # chip_smoke.py's tolerance of K5a against its plain version
N_WARPS = 8
F32 = torch.float32


def _viewmat(angles, t):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = Rotation.from_euler("xyz", angles, degrees=True).as_matrix()
    c2w[:3, 3] = t
    return invert_se3(jnp.asarray(c2w))


def _cloud(opacity, n=300, seed=4):
    """A random cloud of heterogeneous isotropic splats."""
    rng = np.random.default_rng(seed)
    pts, rgb = random_gaussian_cloud(rng, n)
    scene = scene_from_point_cloud(jnp.asarray(pts), jnp.asarray(rgb))
    s = rng.uniform(0.02, 0.08, (n, 1)).astype(np.float32)
    return scene._replace(scales=jnp.asarray(np.repeat(s, 3, axis=1)),
                          opacities=jnp.full_like(scene.opacities, opacity))


def _case(name):
    """(proj8, meta, n_ty, n_tx, sin) of one sub-tile walk: the slot buffer
    built by the reference, projected by the port at a pose about a pixel
    off the build pose, the forward's rows and random cotangents."""
    if name == "boxroom":  # one ~1 px splat per pixel, as the smoke's scene
        h, w = 32, 64
        scene, _, K = box_scene(h, w)
        vm_b = jnp.eye(4)
        vm_r = _viewmat((0.3, -0.2, 0.25), (0.004, -0.003, 0.005))
    else:
        h, w = 32, 128
        scene = _cloud(1.0 if name == "cloud_opa1" else 0.55)
        K = camera.intrinsics_matrix(70.0, 70.0, w / 2 - 0.5, h / 2 - 0.5)
        vm_b = _viewmat((1, -0.5, 0.8), (0.01, -0.015, 0.02))
        vm_r = _viewmat((1.1, -0.4, 0.7), (0.012, -0.013, 0.021))
    slot, meta, _ = jfs.build_subtile_slot_buffer(scene, vm_b, jnp.asarray(K),
                                                  w, h, NEAR, FAR)
    n_ty, n_tx = -(-h // 16), -(-w // 128)
    cam = cam_vector(tt(np.asarray(vm_r)), tt(np.asarray(K)), w, h)
    p8 = tfs._project8(tt(np.asarray(slot)), cam, NEAR, FAR)
    meta = tt(np.asarray(meta), torch.int32)
    out, cd = tfs._subtile_fwd_plain(p8, meta, n_ty, n_tx)
    g = np.random.default_rng(0).standard_normal(
        (2, out.shape[1])).astype(np.float32)
    sin = torch.cat([out, torch.as_tensor(g)])
    return p8, meta, n_ty, n_tx, sin, cd


_CASES = {}


def case(name):
    if name not in _CASES:
        _CASES[name] = _case(name)
    return _CASES[name]


NAMES = ["boxroom", "cloud_opa1", "cloud_opa055"]


# ------------------------------------------------------------- emulations

def _pixels():
    flat = torch.arange(tfs.P_SUB)
    row, col = flat // tfs.SUB_W, flat % tfs.SUB_W
    yl = row.to(F32) + 0.5
    xl = col.to(F32) + 0.5
    return row, col, xl, yl


def _chunk(p8, meta, n_tx, segs, c):
    """Coefficients (n, CHUNK, 8), (ul, vl) (n, CHUNK) and columns of chunk
    c of the segments segs."""
    n_seg = meta.shape[0] - 2
    starts, _ = tfs._segment_bounds(meta, n_seg)
    x0, y0 = tfs._segment_origins(meta, n_seg, n_tx)
    idx = (starts[segs][:, None] + c * tfs.CHUNK
           + torch.arange(tfs.CHUNK)[None, :])
    n = segs.numel()
    xa = x0[segs][:, None].expand(n, tfs.CHUNK)
    ya = y0[segs][:, None].expand(n, tfs.CHUNK)
    rec = p8[:, idx.reshape(-1)]
    coef = tfs._coeff_mat(rec, xa.reshape(1, -1), ya.reshape(1, -1))
    ul = (rec[0] - xa.reshape(-1)).reshape(n, tfs.CHUNK)
    vl = (rec[1] - ya.reshape(-1)).reshape(n, tfs.CHUNK)
    return coef.reshape(n, tfs.CHUNK, 8), ul, vl, idx


def _pair_step(cj, t, run, g_d, g_a, g_tot, xl, yl):
    """The kernel's per-(slot, pixel) arithmetic for slot coefficients cj
    (n, 8) against every pixel (n, P_SUB): (ds, wg, t_incl, run_new)."""
    xx, xy, yy = xl * xl, xl * yl, yl * yl
    sigma = (cj[:, 0:1] + cj[:, 1:2] * xl + cj[:, 2:3] * yl
             + cj[:, 3:4] * xx + cj[:, 4:5] * xy + cj[:, 5:6] * yy)
    alpha = torch.clamp_max(cj[:, 7:8] * torch.exp(-sigma), tfs.ALPHA_MAX)
    alpha = torch.where((sigma >= -tfs.SIG_EPS) & (alpha >= tfs.ALPHA_MIN),
                        alpha, 0.0)
    one_minus = 1.0 - alpha
    t_incl = t * one_minus
    live = t_incl > tfs.T_EPS
    w = torch.where(live, t * alpha, 0.0)
    phi = g_d * cj[:, 6:7] + g_a
    run_new = run + w * phi
    suffix = g_tot - run_new
    inv_om = 1.0 / torch.clamp_min(one_minus, 1.0 - tfs.ALPHA_MAX)
    d_alpha = t * phi - suffix * inv_om
    d_alpha = torch.where(live & (alpha > 0.0), d_alpha, 0.0)
    d_alpha = torch.where(alpha >= tfs.ALPHA_MAX, 0.0, d_alpha)
    return d_alpha * (-alpha), w * g_d, t_incl, run_new


def _row_moments(ds, wg, cols):
    """Per slot and pixel row, the 7 moments of the kernel's row sums in
    column order; cols (n, C, 16) bool: the columns summed. Returns (7, n,
    C, 16 rows)."""
    n, c = ds.shape[:2]
    ds = ds.reshape(n, c, tfs.SUB_H, tfs.SUB_W)
    wg = wg.reshape(n, c, tfs.SUB_H, tfs.SUB_W)
    z = torch.zeros((n, c, tfs.SUB_H), dtype=F32)
    s0, sx, sxx, swg = z, z, z, z
    for cc in range(tfs.SUB_W):
        v, g = ds[..., cc], wg[..., cc]
        x = float(cc) + 0.5
        inc = cols[..., cc:cc + 1]
        s0 = torch.where(inc, s0 + v, s0)
        sx = torch.where(inc, sx + v * x, sx)
        sxx = torch.where(inc, sxx + v * (x * x), sxx)
        swg = torch.where(inc, swg + g, swg)
    ry = torch.arange(tfs.SUB_H, dtype=F32) + 0.5
    return torch.stack([s0, sx, ry * s0, sxx, ry * sx, (ry * ry) * s0, swg])


def walk_unculled(p8, sin, meta, n_ty, n_tx):
    """The unculled kernel's moments (8, M_pad): every slot against all 256
    pixels while any pixel of the sub-tile is alive, with its sum order."""
    n_seg = n_ty * n_tx * tfs.N_SUB
    starts, ends = tfs._segment_bounds(meta, n_seg)
    seg_chunks = (ends - starts) // tfs.CHUNK
    enc = tfs._segment_enc(meta, n_seg, n_tx)
    _, _, xl, yl = _pixels()
    px = sin.reshape(4, n_seg, tfs.P_SUB)
    g_d, g_a = px[2], px[3]
    g_tot = g_d * px[0] + g_a * px[1]
    t = torch.ones((n_seg, tfs.P_SUB))
    run = torch.zeros_like(t)
    mom = torch.zeros((8, p8.shape[1]))
    for c in range(int(seg_chunks.max())):
        act = torch.nonzero((t.max(dim=1).values > tfs.T_EPS)
                            & (c < seg_chunks))[:, 0]
        if act.numel() == 0:
            break
        coef, _, _, idx = _chunk(p8, meta, n_tx, act, c)
        ta, ra = t[act], run[act]
        ds = torch.zeros((act.numel(), tfs.CHUNK, tfs.P_SUB))
        wg = torch.zeros_like(ds)
        for j in range(tfs.CHUNK):
            cj = coef[:, j]
            on = cj[:, 7:8] != 0.0
            d, gw, t_incl, r_new = _pair_step(cj, ta, ra, g_d[act], g_a[act],
                                              g_tot[act], xl, yl)
            ds[:, j] = torch.where(on, d, 0.0)
            wg[:, j] = torch.where(on, gw, 0.0)
            ta = torch.where(on, t_incl, ta)
            ra = torch.where(on, r_new, ra)
        t[act], run[act] = ta, ra
        m = _row_moments(ds, wg, torch.ones(ds.shape[:2] + (16,),
                                            dtype=torch.bool))
        part = m[..., 0::2] + m[..., 1::2]  # (7, n, C, 8 warps)
        v = torch.zeros(part.shape[:3])
        for w in range(N_WARPS):
            v = v + part[..., w]
        mom[:7, idx.reshape(-1)] = v.reshape(7, -1)
        mom[7, idx.reshape(-1)] = enc[act].repeat_interleave(tfs.CHUNK)
    return mom


def walk_culled(p8, sin, meta, n_ty, n_tx, chunks_done):
    """The culled kernel's walk over chunks_done chunks per sub-tile.
    Returns (mom (8, M_pad), stops (n_seg, 8): the chunk at which each warp
    stopped evaluating, met (slot, warp) pairs, multi-warp slots)."""
    n_seg = n_ty * n_tx * tfs.N_SUB
    enc = tfs._segment_enc(meta, n_seg, n_tx)
    row, col, xl, yl = _pixels()
    warp_of = row // 2
    px = sin.reshape(4, n_seg, tfs.P_SUB)
    g_d, g_a = px[2], px[3]
    g_tot = g_d * px[0] + g_a * px[1]
    t = torch.ones((n_seg, tfs.P_SUB))
    run = torch.zeros_like(t)
    walking = torch.ones((n_seg, N_WARPS), dtype=torch.bool)
    stops = chunks_done.long()[:, None].repeat(1, N_WARPS)
    mom = torch.zeros((8, p8.shape[1]))
    met_pairs = multi = 0
    cd = chunks_done.long()
    for c in range(int(cd.max()) if n_seg else 0):
        act = torch.nonzero(c < cd)[:, 0]
        # each warp stops at the first chunk boundary with no live pixel
        alive = (t[act] > tfs.T_EPS).reshape(-1, N_WARPS, 32).any(dim=2)
        now = walking[act] & ~alive
        stops[act] = torch.where(now, c, stops[act])
        walking[act] = walking[act] & alive
        wk = walking[act]
        coef, ul, vl, idx = _chunk(p8, meta, n_tx, act, c)
        c_lo, c_hi, r_lo, r_hi = tfs._subtile_box(coef, ul, vl)
        nonempty = (c_lo <= c_hi) & (r_lo <= r_hi)
        w_ids = torch.arange(N_WARPS)
        wset = (nonempty[..., None] & (r_lo[..., None] <= 2 * w_ids + 1)
                & (r_hi[..., None] >= 2 * w_ids))  # (n, C, 8)
        met_pairs += int(wset.sum())
        multi += int((wset.sum(-1) > 1).sum())
        ta, ra = t[act], run[act]
        ds = torch.zeros((act.numel(), tfs.CHUNK, tfs.P_SUB))
        wg = torch.zeros_like(ds)
        for j in range(tfs.CHUNK):
            inbox = ((col >= c_lo[:, j:j + 1]) & (col <= c_hi[:, j:j + 1])
                     & (row >= r_lo[:, j:j + 1]) & (row <= r_hi[:, j:j + 1]))
            ev = (inbox & wset[:, j][:, warp_of] & wk[:, warp_of]
                  & (ta > tfs.T_EPS))
            d, gw, t_incl, r_new = _pair_step(coef[:, j], ta, ra, g_d[act],
                                              g_a[act], g_tot[act], xl, yl)
            ds[:, j] = torch.where(ev, d, 0.0)
            wg[:, j] = torch.where(ev, gw, 0.0)
            ta = torch.where(ev, t_incl, ta)
            ra = torch.where(ev, r_new, ra)
        t[act], run[act] = ta, ra
        cols = ((torch.arange(16) >= c_lo[..., None])
                & (torch.arange(16) <= c_hi[..., None]))
        m = _row_moments(ds, wg, cols)
        part = m[..., 0::2] + m[..., 1::2]  # (7, n, C, 8 warps)
        # a warp that no longer walks contributes its +0 partial
        part = torch.where(wk[None, :, None, :], part, 0.0)
        v = torch.zeros(part.shape[:3])
        for w in range(N_WARPS):
            v = torch.where(wset[None, ..., w], v + part[..., w], v)
        mom[:7, idx.reshape(-1)] = v.reshape(7, -1)
        mom[7, idx.reshape(-1)] = enc[act].repeat_interleave(tfs.CHUNK)
    return mom, stops, met_pairs, multi


def _bits(x):
    return x.contiguous().view(torch.int32)


# ------------------------------------------------------------------ box

def _hits_outside(coef, ul, vl):
    """Gate hits of `_sub_alpha` outside their slot's `_subtile_box`, and
    the hits. coef (C, 8), ul/vl (C,)."""
    alpha = tfs._sub_alpha(coef, tfs._sub_mono("cpu"))
    row, col, _, _ = _pixels()
    c_lo, c_hi, r_lo, r_hi = tfs._subtile_box(coef, ul, vl)
    inside = ((col >= c_lo[:, None]) & (col <= c_hi[:, None])
              & (row >= r_lo[:, None]) & (row <= r_hi[:, None]))
    hit = alpha > 0.0
    return int((hit & ~inside).sum()), int(hit.sum())


@pytest.mark.parametrize("name", NAMES)
def test_box_holds_every_gate_hit_of_the_walked_chunks(name):
    p8, meta, n_ty, n_tx, _, cd = case(name)
    outside = hits = area = 0
    for c in range(int(cd.max())):
        act = torch.nonzero(c < cd.long())[:, 0]
        coef, ul, vl, _ = _chunk(p8, meta, n_tx, act, c)
        o, h = _hits_outside(coef.reshape(-1, 8), ul.reshape(-1),
                             vl.reshape(-1))
        outside += o
        hits += h
        c_lo, c_hi, r_lo, r_hi = tfs._subtile_box(coef, ul, vl)
        area += int(((c_hi - c_lo + 1).clamp_min(0)
                     * (r_hi - r_lo + 1).clamp_min(0)).sum())
    walked = int(cd.sum()) * tfs.CHUNK
    assert hits > 0
    assert outside == 0
    # the boxes are a small part of what the unculled walk evaluates
    assert hits <= area < 0.25 * walked * tfs.P_SUB, (hits, area, walked)


def _hand_coef(u, v, ca, cb, cc, opaok, x0=0.0, y0=0.0):
    rec = torch.zeros((8, len(u)), dtype=F32)
    for r, vals in enumerate((u, v, ca, cb, cc)):
        rec[r] = torch.as_tensor(np.asarray(vals, np.float32))
    rec[5] = 1.0
    rec[6] = torch.as_tensor(np.asarray(opaok, np.float32))
    rec[7] = 1.0
    coef = tfs._coeff_mat(rec, x0, y0)
    return coef, rec[0] - x0, rec[1] - y0


def test_box_holds_the_hits_of_hand_made_slots():
    """Needles, centres far outside the sub-tile, opacities at and about
    1/255, and a fuzz of random conics around the sub-tile (the fuzz
    seeded): no gate hit outside its box."""
    rng = np.random.default_rng(11)
    n = 4000
    ang = rng.uniform(0, np.pi, n)
    s_major = np.exp(rng.uniform(np.log(0.3), np.log(60.0), n))
    s_minor = np.exp(rng.uniform(np.log(0.3), np.log(3.0), n))
    c, s = np.cos(ang), np.sin(ang)
    # covariance R diag(s^2) R^T + 0.3 I, then its inverse, the conic
    a = c * c * s_major ** 2 + s * s * s_minor ** 2 + 0.3
    b = c * s * (s_major ** 2 - s_minor ** 2)
    d = s * s * s_major ** 2 + c * c * s_minor ** 2 + 0.3
    det = a * d - b * b
    ca, cb, cc = d / det, -b / det, a / det
    u = rng.uniform(-40.0, 56.0, n)
    v = rng.uniform(-40.0, 56.0, n)
    opa = np.concatenate([
        np.full(500, np.float32(1.0 / 255.0)),
        np.nextafter(np.full(500, np.float32(1.0 / 255.0)), np.float32(0)),
        np.full(500, np.float32(1.0 / 255.0 / 1.005)),
        rng.uniform(0.01, 1.0, n - 1500)])
    # sub-tile origins far from 0: the centre cancels in c0
    for x0, y0 in ((0.0, 0.0), (1184.0, 672.0)):
        coef, ul, vl = _hand_coef(u + x0, v + y0, ca, cb, cc, opa, x0, y0)
        outside, hits = _hits_outside(coef, ul, vl)
        assert hits > 0
        assert outside == 0, (x0, y0, outside)


def test_box_cases():
    """Each case of subtile_box: opacity*ok 0 is empty whatever its fields
    hold, a non-finite field or a form that is not positive definite keeps
    the whole sub-tile, an opacity below 1/255 (beyond the f32 slack) and a
    centre far away are empty, a one-pixel splat is a few pixels."""
    whole = (0, 15, 0, 15)
    empty = (16, -1, 16, -1)
    inf, nan = float("inf"), float("nan")
    rows = [  # u, v, ca, cb, cc, opa*ok, expected
        (8.0, 8.0, 1.0, 0.0, 1.0, 0.0, empty),
        (nan, 8.0, 1.0, 0.0, 1.0, 0.0, empty),
        (inf, 8.0, 1.0, 0.0, 1.0, 0.5, whole),
        (8.0, 8.0, nan, 0.0, 1.0, 0.5, whole),
        (8.0, 8.0, 1.0, 0.0, 1.0, nan, whole),
        (8.0, 8.0, 1.0, 2.0, 1.0, 0.5, whole),  # indefinite
        (8.0, 8.0, -1.0, 0.0, -1.0, 0.5, whole),  # negative definite
        (8.0, 8.0, 1.0, 1.0, 1.0, 0.5, whole),  # semidefinite
        (8.0, 8.0, 1.0, 0.0, 1.0, -0.5, empty),
        (8.0, 8.0, 1.0, 0.0, 1.0, 1e-3, empty),
        (200.0, 8.0, 1.0, 0.0, 1.0, 1.0, empty),
        (1e5, 8.0, 1.0, 0.0, 1.0, 1.0, whole),  # the f32 error is too large
        (8.3, 8.6, 1.7, 0.0, 1.7, 1.0, (6, 10, 6, 10)),
    ]
    coef, ul, vl = _hand_coef(*[[r[i] for r in rows] for i in range(6)])
    got = torch.stack(tfs._subtile_box(coef, ul, vl), dim=1).tolist()
    for r, g in zip(rows, got):
        assert tuple(g) == r[6], (r, g)
    outside, hits = _hits_outside(coef, ul, vl)
    assert outside == 0 and hits > 0


# ----------------------------------------------------------------- walks

@pytest.mark.parametrize("name", NAMES)
def test_culled_walk_equals_the_unculled_walk_bit_for_bit(name):
    """The culled walk's moments carry the unculled walk's bits exactly
    (signed zeros included), and both are within TOL_MOM_REL of each row's
    largest magnitude of the plain version; row 7 and the zero fill are
    equal."""
    p8, meta, n_ty, n_tx, sin, cd = case(name)
    full = walk_unculled(p8, sin, meta, n_ty, n_tx)
    cull, _, met, _ = walk_culled(p8, sin, meta, n_ty, n_tx, cd)
    assert met > 0
    assert torch.equal(_bits(cull), _bits(full))
    plain = tfs._subtile_bwd_plain(p8, sin, meta, n_ty, n_tx)
    for r in range(7):
        scale = float(plain[r].abs().max())
        assert scale > 0
        assert float((full[r] - plain[r]).abs().max()) <= TOL_MOM_REL * scale
    assert torch.equal(full[7], plain[7])
    assert torch.equal((full == 0).all(dim=0), (plain == 0).all(dim=0))


@pytest.mark.parametrize("name", NAMES)
def test_chunks_done_is_the_largest_of_the_warps_stops(name):
    """Each warp stops at its own chunk; the largest of the 8 stops is the
    forward's chunks_done (the block-wide vote). On these scenes every warp
    of a sub-tile stops at the same chunk; the hand-made sub-tile below
    has warps that stop apart."""
    p8, meta, n_ty, n_tx, sin, cd = case(name)
    _, stops, _, _ = walk_culled(p8, sin, meta, n_ty, n_tx, cd)
    assert int(cd.max()) >= 1
    assert torch.equal(stops.max(dim=1).values, cd.long())


def test_culled_walk_stops_warps_apart_on_a_hand_made_sub_tile():
    """One sub-tile: opaque splats over rows 0-3 first, then 504 faint
    slots over the whole sub-tile. Warps 0-1 stop after the first chunk,
    the others walk all four; moments bit-equal to the unculled walk."""
    m_pad = 8192
    n = 512
    p8 = torch.zeros((8, m_pad))
    # slots 0-7: opaque splats flat across the sub-tile and narrow in y,
    # two on each of rows 0-3
    for k in range(8):
        p8[:, k] = torch.tensor([8.0, 0.5 + k // 2, 1e-4, 0.0, 20.0,
                                 1.0 + 1e-3 * k, 1.0, 1.0])
    # slots 8-511: faint wide splats over the whole sub-tile, deeper
    rng = np.random.default_rng(3)
    m = n - 8
    p8[0, 8:n] = torch.as_tensor(rng.uniform(0, 16, m).astype(np.float32))
    p8[1, 8:n] = torch.as_tensor(rng.uniform(0, 16, m).astype(np.float32))
    p8[2, 8:n] = 0.02
    p8[4, 8:n] = 0.02
    p8[5, 8:n] = torch.linspace(2.0, 3.0, m)
    p8[6, 8:n] = 0.02
    p8[7, 8:n] = 1.0
    meta = torch.zeros(10, dtype=torch.int32)
    meta[2] = n
    meta[3:] = n
    n_ty = n_tx = 1
    out, cd = tfs._subtile_fwd_plain(p8, meta, n_ty, n_tx)
    g = np.random.default_rng(5).standard_normal(
        (2, out.shape[1])).astype(np.float32)
    sin = torch.cat([out, torch.as_tensor(g)])
    cull, stops, _, _ = walk_culled(p8, sin, meta, n_ty, n_tx, cd)
    assert int(cd[0]) == 4
    assert stops[0].tolist() == [1, 1, 4, 4, 4, 4, 4, 4]
    assert int(stops[0].max()) == int(cd[0])
    full = walk_unculled(p8, sin, meta, n_ty, n_tx)
    assert torch.equal(_bits(cull), _bits(full))
