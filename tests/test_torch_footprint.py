"""The footprint box of the tile walks (ops/rasterize_tiles.py
_footprint_box, the plain form of csrc/rasterize.cuh footprint_box, which
K6b and K7b use to skip the (slot, pixel) pairs outside it): every pair
that passes `_chunk_alpha`'s gates must lie inside its slot's box, on
synthetic conics at the edges of the margins, on the general path's slot
buffer made by the JAX package, and on the full-tile path's projected rows
as K7b sees them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplatloc_tpu.ops import binning as jbinning
from gsplatloc_tpu.ops import rasterize_pallas as jrp
from gsplatloc_tpu_torch.data.synthetic import box_room_frame
from gsplatloc_tpu_torch.models.gaussians import scene_from_point_cloud
from gsplatloc_tpu_torch.ops import fused_tracking as ft
from gsplatloc_tpu_torch.ops import rasterize_tiles as rt
from gsplatloc_tpu_torch.ops.binning import TILE_H, TILE_W
from gsplatloc_tpu_torch.ops.camera import depth_to_points
from gsplatloc_tpu_torch.ops.lie import invert_se3
from test_torch_rasterize import H, W, _cloud, _projected, _viewmat
from torch_port_helpers import intrinsics, perturbed_c2w

AMIN = float(np.float32(rt.ALPHA_MIN))
N_SYN = 640  # slots of a synthetic case: 5 chunks of one tile


def _records(mx, my, ca, cb, cc, opa):
    """(16, M_pad) record buffer holding the given fields 0-4 and 6 (f32),
    padded with zero columns to whole chunks."""
    m = len(mx)
    m_pad = -(-m // rt.CHUNK) * rt.CHUNK
    rec = np.zeros((rt.NUM_REC_ROWS, m_pad), np.float32)
    for k, v in zip((0, 1, 2, 3, 4, 6), (mx, my, ca, cb, cc, opa)):
        rec[k, :m] = np.asarray(v, np.float32)
    return torch.from_numpy(rec)


def _one_tile(rec, m, tile=(1, 2), row_off=3):
    """Every slot in one tile (ti, tj) of a 2 x 3 grid, the grid shifted
    down by row_off tile rows: the box sees x0 = 128 tj, y0 = 16 (ti +
    row_off). Returns (records, meta, n_ty, n_tx)."""
    n_ty, n_tx = 2, 3
    t = tile[0] * n_tx + tile[1]
    starts = [0] * (t + 1) + [m] * (n_ty * n_tx - t)
    return rec, torch.tensor([row_off] + starts, dtype=torch.int32), n_ty, n_tx


def _tile_origin(ti, tj, row_off):
    return np.float32(tj * TILE_W), np.float32((ti + row_off) * TILE_H)


def _conic(cov):
    """f32 conic of (..., 3) covariances [a, b, c], as the projection makes
    it (det, 1/det, c/det, -b/det, a/det)."""
    a, b, c = (cov[..., k].astype(np.float32) for k in range(3))
    inv = np.float32(1.0) / (a * c - b * b)
    return c * inv, -b * inv, a * inv


def _centres(rng, n, tile=(1, 2), row_off=3, spill=20.0):
    """Random sub-pixel centres over the tile and `spill` pixels around."""
    x0, y0 = _tile_origin(tile[0], tile[1], row_off)
    mx = x0 + rng.uniform(-spill, TILE_W + spill, n)
    my = y0 + rng.uniform(-spill, TILE_H + spill, n)
    return mx.astype(np.float32), my.astype(np.float32)


def _case_isotropic(rng):
    mx, my = _centres(rng, N_SYN)
    var = rng.uniform(0.3, 20.0, N_SYN).astype(np.float32)
    ca = np.float32(1.0) / var
    opa = rng.uniform(0.01, 1.0, N_SYN)
    return _one_tile(_records(mx, my, ca, np.zeros_like(ca), ca, opa), N_SYN)


def _case_anisotropic(rng):
    """Rotated needles at the EPS2D floor: cov = R diag(lam, 0) R^T + 0.3 I,
    lam up to 1e5 (kappa = ca cc / det past 2^16 keeps the whole tile)."""
    mx, my = _centres(rng, N_SYN)
    lam = 10.0 ** rng.uniform(0.0, 5.0, N_SYN)
    th = rng.uniform(0.0, np.pi, N_SYN)
    cov = np.stack([lam * np.cos(th) ** 2 + 0.3,
                    lam * np.cos(th) * np.sin(th),
                    lam * np.sin(th) ** 2 + 0.3], axis=-1)
    ca, cb, cc = _conic(cov)
    opa = rng.uniform(0.05, 1.0, N_SYN)
    return _one_tile(_records(mx, my, ca, cb, cc, opa), N_SYN)


def _case_wide(rng):
    """Footprints far wider than the tile: the box clamps to it."""
    mx, my = _centres(rng, N_SYN, spill=4.0)
    var = (10.0 ** rng.uniform(4.0, 6.0, N_SYN)).astype(np.float32)
    ca = np.float32(1.0) / var
    return _one_tile(_records(mx, my, ca, np.zeros_like(ca), ca,
                              np.ones(N_SYN)), N_SYN)


def _case_opacity_edges(rng):
    """Opacity at ALPHA_MIN (1 -/+ 1e-6) and at 1.0, centres on pixel
    centres (sigma = 0 at one pixel)."""
    x0, y0 = _tile_origin(1, 2, 3)
    mx = x0 + rng.integers(0, TILE_W, N_SYN) + np.float32(0.5)
    my = y0 + rng.integers(0, TILE_H, N_SYN) + np.float32(0.5)
    ca = (np.float32(1.0) / rng.uniform(0.3, 4.0, N_SYN)).astype(np.float32)
    opa = np.array([AMIN * (1 - 1e-6), AMIN, AMIN * (1 + 1e-6), 1.0],
                   np.float32)[np.arange(N_SYN) % 4]
    return _one_tile(_records(mx, my, ca, np.zeros_like(ca), ca, opa), N_SYN)


def _case_opacity_zero(rng):
    mx, my = _centres(rng, N_SYN)
    ca = np.full(N_SYN, 0.5, np.float32)
    return _one_tile(_records(mx, my, ca, np.zeros_like(ca), ca,
                              np.zeros(N_SYN)), N_SYN)


def _case_degenerate(rng):
    """Conics that are not positive definite, and NaN / Inf fields."""
    mx, my = _centres(rng, N_SYN, spill=2.0)
    ca = rng.uniform(0.05, 0.5, N_SYN)
    cc = rng.uniform(0.05, 0.5, N_SYN)
    # det <= 0 for a third, ca <= 0 and cc <= 0 for the others
    cb = np.sqrt(ca * cc) * rng.uniform(1.0, 2.0, N_SYN) * rng.choice(
        [-1.0, 1.0], N_SYN)
    kind = np.arange(N_SYN) % 3
    ca = np.where(kind == 1, -ca * (np.arange(N_SYN) % 2), ca)
    cc = np.where(kind == 2, -cc, cc)
    cb = np.where(kind == 0, cb, 0.1 * cb)
    mx, my, ca, cb, cc = (v.astype(np.float32) for v in (mx, my, ca, cb, cc))
    opa = np.ones(N_SYN, np.float32)
    bad = np.array([np.nan, np.inf, -np.inf], np.float32)
    for k, field in enumerate((mx, my, ca, cb, cc, opa)):
        idx = np.arange(k, N_SYN, 24)
        field[idx] = bad[np.arange(len(idx)) % 3]
    return _one_tile(_records(mx, my, ca, cb, cc, opa), N_SYN)


def _case_rims(rng):
    """Sub-pixel centres placed so that the gate's rim sigma = ln(opa /
    ALPHA_MIN) falls on a pixel centre (isotropic and anisotropic)."""
    x0, y0 = _tile_origin(1, 2, 3)
    px = x0 + rng.integers(0, TILE_W, N_SYN) + 0.5
    py = y0 + rng.integers(0, TILE_H, N_SYN) + 0.5
    lam = 10.0 ** rng.uniform(-0.5, 2.0, N_SYN)
    th = rng.uniform(0.0, np.pi, N_SYN)
    iso = np.arange(N_SYN) % 2 == 0
    cov = np.stack([lam * np.cos(th) ** 2 + 0.3,
                    np.where(iso, 0.0, lam * np.cos(th) * np.sin(th)),
                    np.where(iso, lam + 0.3, lam * np.sin(th) ** 2 + 0.3)],
                   axis=-1)
    cov[iso, 0] = lam[iso] + 0.3
    ca, cb, cc = _conic(cov)
    opa = rng.uniform(0.02, 1.0, N_SYN).astype(np.float32)
    q = np.array([ca, cb, cb, cc], np.float64).T.reshape(-1, 2, 2)
    # a random direction d, scaled onto the rim d^T Q d = 2 ln(opa/AMIN)
    phi = rng.uniform(0.0, 2 * np.pi, N_SYN)
    d = np.stack([np.cos(phi), np.sin(phi)], axis=-1)
    qd = np.einsum("nij,nj->ni", q, d)
    scale = np.sqrt(2 * np.log(opa / AMIN) / np.einsum("ni,ni->n", d, qd))
    mx = (px - scale * d[:, 0]).astype(np.float32)
    my = (py - scale * d[:, 1]).astype(np.float32)
    return _one_tile(_records(mx, my, ca, cb, cc, opa), N_SYN)


def _case_packed(_rng):
    """The slot buffer of test_torch_rasterize.py's `packed` fixture (the
    JAX package's projection, binning and record gather, 2 x 2 tiles)."""
    c = _cloud(n=220, seed=3)
    proj, rgb = _projected(c, H, W, _viewmat())
    b = jbinning.bin_and_sort(proj.mean2d, proj.radius, proj.depth,
                              proj.valid, W, H)
    rows = [proj.mean2d[:, 0], proj.mean2d[:, 1], proj.conic[:, 0],
            proj.conic[:, 1], proj.conic[:, 2], proj.depth,
            jnp.asarray(c["opacities"]), rgb[:, 0], rgb[:, 1], rgb[:, 2]]
    rec = jnp.stack(rows + [jnp.zeros_like(proj.depth)] * 6, axis=1)
    kmax = b.inv_perm.shape[0] // rec.shape[0]
    pk = jrp.gather_slots(rec, b.pair_gauss, b.inv_perm, kmax)
    meta = jnp.concatenate([jnp.zeros((1,), jnp.int32), b.tile_starts])
    return (torch.from_numpy(np.array(pk)),
            torch.from_numpy(np.array(meta)), b.n_tiles_y, b.n_tiles_x)


def _case_projected(_rng):
    """The projected rows of a build_slot_buffer scene at a displaced pose
    (u, v, ca, cb, cc, qz and opacity * ok), as K7b stages them."""
    h, w = 48, 256
    K = torch.as_tensor(intrinsics(h, w))
    rgb, depth = box_room_frame(np.eye(4), K.numpy(), h, w, clutter=10)
    scene = scene_from_point_cloud(
        depth_to_points(torch.as_tensor(depth), K),
        torch.as_tensor(rgb.reshape(-1, 3)), grid_shape=(h, w),
        knn_method="grid", device="cpu")
    vm = invert_se3(torch.as_tensor(perturbed_c2w((0.8, -0.6, 0.5),
                                                  (0.02, -0.01, 0.03))))
    slot, meta, b = ft.build_slot_buffer(scene, vm, K, w, h, 1e-2, 1e10)
    cam = ft.cam_vector(vm, K, w, h)
    p8 = ft._project8_rows(ft._project_slots(slot, cam), 1e-2, 1e10)
    rec = torch.zeros((rt.NUM_REC_ROWS, slot.shape[1]), dtype=torch.float32)
    rec[:6] = p8[:6]
    rec[6] = p8[6] * p8[7]
    return rec, meta, b.n_tiles_y, b.n_tiles_x


CASES = {
    "isotropic": _case_isotropic,
    "anisotropic_eps2d": _case_anisotropic,
    "wide_clamped": _case_wide,
    "opacity_edges": _case_opacity_edges,
    "opacity_zero": _case_opacity_zero,
    "degenerate_nonfinite": _case_degenerate,
    "rims_on_pixel_centres": _case_rims,
    "packed_general": _case_packed,
    "projected_fulltile": _case_projected,
}


def _walk_boxes(records, meta, n_ty, n_tx):
    """Every in-segment (slot, pixel) pair of every chunk of every tile:
    the pairs that pass `_chunk_alpha`'s gates, those of them outside their
    slot's box, and the boxes (n_slots, 4) in walk order."""
    n_tiles = n_ty * n_tx
    starts, ends, base, n_chunks = rt._tile_bounds(meta, n_tiles)
    px, py = rt._pixel_xy(n_ty, n_tx, meta[0].long(), records.device)
    t = torch.arange(n_tiles)
    x0 = (t % n_tx).to(torch.float32) * TILE_W
    y0 = (t // n_tx + meta[0].long()).to(torch.float32) * TILE_H
    col = torch.arange(rt.P) % TILE_W
    row = torch.arange(rt.P) // TILE_W
    hits = outside = 0
    boxes = []
    for c in range(int(n_chunks.max()) if n_tiles else 0):
        act = torch.nonzero(c < n_chunks)[:, 0]
        alpha, _dx, _dy, in_seg, rec = rt._chunk_alpha(
            records, base[act] + c * rt.CHUNK, starts[act], ends[act],
            px[act], py[act])
        box = rt._footprint_box(rec[0], rec[1], rec[2], rec[3], rec[4],
                                rec[6], x0[act][:, None], y0[act][:, None])
        c_lo, c_hi, r_lo, r_hi = (b[..., None] for b in box)
        inside = ((col >= c_lo) & (col <= c_hi) & (row >= r_lo)
                  & (row <= r_hi))
        hit = alpha > 0.0
        hits += int(hit.sum())
        outside += int((hit & ~inside).sum())
        boxes.append(torch.stack(box, dim=-1)[in_seg])
    return hits, outside, torch.cat(boxes)


@pytest.mark.parametrize("case", list(CASES))
def test_gate_hits_lie_inside_the_footprint_box(case):
    """No pair that passes the gates lies outside its slot's box (the walk
    may skip those pairs as exact no-ops); each case also shows the box
    behaviour it was built for."""
    rng = np.random.default_rng(sorted(CASES).index(case))
    records, meta, n_ty, n_tx = CASES[case](rng)
    hits, outside, boxes = _walk_boxes(records, meta, n_ty, n_tx)
    assert outside == 0, f"{outside} of {hits} gate hits outside the box"
    whole = torch.tensor([0, TILE_W - 1, 0, TILE_H - 1])
    empty = torch.tensor([TILE_W, -1, TILE_H, -1])
    is_whole = (boxes == whole).all(dim=1)
    is_empty = (boxes == empty).all(dim=1)
    # a box is either empty or a non-empty rectangle inside the tile
    ok = is_empty | ((boxes[:, 0] <= boxes[:, 1])
                     & (boxes[:, 2] <= boxes[:, 3]) & (boxes[:, 0] >= 0)
                     & (boxes[:, 1] < TILE_W) & (boxes[:, 2] >= 0)
                     & (boxes[:, 3] < TILE_H))
    assert bool(ok.all())
    area = ((boxes[:, 1] - boxes[:, 0] + 1).clamp_min(0)
            * (boxes[:, 3] - boxes[:, 2] + 1).clamp_min(0))
    if case == "opacity_zero":
        assert hits == 0 and bool(is_empty.all())
        return
    assert hits > 0
    if case == "degenerate_nonfinite":
        assert bool(is_whole.all())
    elif case == "wide_clamped":
        assert float(is_whole.float().mean()) > 0.5
    elif case == "opacity_edges":
        below = records[6, :N_SYN] < AMIN
        assert bool(is_empty[below].all()) and not bool(is_empty[~below].any())
    elif case == "anisotropic_eps2d":
        # the thinnest needles keep the whole tile, the others are culled
        assert bool(is_whole.any()) and bool((area < rt.P / 8).any())
    else:
        # the cull leaves a small part of the tile to walk
        assert float(area.float().mean()) < rt.P / 8
