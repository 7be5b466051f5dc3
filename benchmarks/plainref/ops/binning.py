"""Tile binning + depth sort for the tracking renders (PyTorch).

Every Gaussian emits a STATIC number of (tile, depth) slots (KY x KX —
enough to cover its clamped screen radius), the slot list is sorted once by
a packed (tile, quantized depth) key, and per-tile segment offsets come
from a binary search. Static shapes throughout, no host round-trips.

The sort is STABLE (ties keep emission order), so the same inputs give the
same slot order on every device and run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TILE_H = 16
TILE_W = 128


class Binning(NamedTuple):
    pair_gauss: torch.Tensor  # (M_pad,) int32 gaussian index per sorted slot
    tile_starts: torch.Tensor  # (n_tiles + 1,) int32 segment offsets
    inv_perm: torch.Tensor | None  # (M,) sorted position of pair g*K+k
    n_tiles_y: int
    n_tiles_x: int
    num_pairs: int  # M (before padding)


def radius_clamp(tile_h: int, ky: int) -> int:
    """Max radius (px) for which a KY-slot column is guaranteed to cover the
    vertical tile span: r <= TILE_H*(KY-1)/2."""
    return (tile_h * (ky - 1)) // 2


def bin_and_sort(
    mean2d: torch.Tensor,  # (N, 2)
    radius: torch.Tensor,  # (N,) int32 (0 = culled)
    depth: torch.Tensor,  # (N,) camera z (positive for visible)
    valid: torch.Tensor,  # (N,) bool
    width: int,
    height: int,
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
    ky: int = 2,
    kx: int = 2,
    chunk: int = 128,
    exact_sort: bool = False,
    needs_inv_perm: bool = True,
    big_budget: int = 0,
    pad_to_chunks: bool = False,
    pad_align: int = 128,
) -> Binning:
    """Build the depth-sorted per-tile work list.

    exact_sort=True sorts lexicographically by (tile, exact f32 depth);
    the default packs (tile, quantized depth) into one integer key — ties
    within ~2^-(depth_bits) relative depth keep emission order.

    needs_inv_perm=False (the tracking rebuild) skips the inverse
    permutation.

    big_budget > 0 handles BIG splats exactly: the top `big_budget` splats
    by radius that exceed the radius clamp are removed from the clamped
    KY x KX path and emitted into EVERY tile their full (grid-clipped) box
    covers. Tracking-path only (needs_inv_perm=False).

    pad_to_chunks=True rounds every tile segment up to a multiple of
    `chunk` by inserting DEAD slots (pair_gauss = N, pointing one past the
    real records — callers append a zero-opacity dummy record row). The
    returned pair_gauss has STATIC length (worst-case padding, rounded to
    pad_align); the used prefix is tile_starts[-1].
    """
    dev = mean2d.device
    n = mean2d.shape[0]
    n_ty = -(-height // tile_h)
    n_tx = -(-width // tile_w)
    n_tiles = n_ty * n_tx
    clamp_r = radius_clamp(tile_h, ky)

    r = radius.clamp_max(clamp_r).to(torch.float32)
    ok0 = valid & (radius > 0)

    big_tiles = big_gauss = None
    if big_budget:
        if needs_inv_perm:
            raise NotImplementedError(
                "big_budget needs needs_inv_perm=False (tracking path)"
            )
        b = min(big_budget, n)
        # top-b by radius, lower index first among equals (stable sort)
        rv, ri = torch.sort(radius, descending=True, stable=True)
        rv, ri = rv[:b], ri[:b]
        is_sel = torch.zeros((n,), dtype=torch.bool, device=dev)
        is_sel[ri] = rv > clamp_r
        ok0 = ok0 & ~is_sel
        rb = rv.to(torch.float32)
        xb, yb = mean2d[ri, 0], mean2d[ri, 1]
        tx0b = torch.floor((xb - rb) / tile_w).clamp(0, n_tx - 1)
        tx1b = torch.floor((xb + rb) / tile_w).clamp(0, n_tx - 1)
        ty0b = torch.floor((yb - rb) / tile_h).clamp(0, n_ty - 1)
        ty1b = torch.floor((yb + rb) / tile_h).clamp(0, n_ty - 1)
        t_all = torch.arange(n_tiles, dtype=torch.int32, device=dev)
        ty_t = (t_all // n_tx).to(torch.float32)
        tx_t = (t_all % n_tx).to(torch.float32)
        ok_bt = (
            ((rv > clamp_r) & valid[ri])[:, None]
            & (tx_t[None, :] >= tx0b[:, None])
            & (tx_t[None, :] <= tx1b[:, None])
            & (ty_t[None, :] >= ty0b[:, None])
            & (ty_t[None, :] <= ty1b[:, None])
        )  # (B, n_tiles)
        big_tiles = torch.where(
            ok_bt, t_all[None, :], n_tiles).to(torch.int32).reshape(-1)
        big_gauss = ri.to(torch.int32)[:, None].expand(ok_bt.shape).reshape(-1)
    x, y = mean2d[:, 0], mean2d[:, 1]
    tx0 = torch.floor((x - r) / tile_w).to(torch.int32)
    tx1 = torch.floor((x + r) / tile_w).to(torch.int32)
    ty0 = torch.floor((y - r) / tile_h).to(torch.int32)
    ty1 = torch.floor((y + r) / tile_h).to(torch.int32)
    tx0c = tx0.clamp(0, n_tx - 1)
    ty0c = ty0.clamp(0, n_ty - 1)
    tx1c = tx1.clamp(0, n_tx - 1)
    ty1c = ty1.clamp(0, n_ty - 1)

    tiles = []
    for k in range(ky * kx):
        dy, dx = k // kx, k % kx
        ty = ty0c + dy
        tx = tx0c + dx
        ok = ok0 & (ty <= ty1c) & (tx <= tx1c)
        tiles.append(torch.where(ok, ty * n_tx + tx, n_tiles))
    kk = ky * kx
    tile_ids = torch.stack(tiles, dim=1).reshape(-1).to(torch.int32)  # (M,)
    gauss_idx = torch.arange(n, dtype=torch.int32, device=dev)[:, None] \
        .expand(n, kk).reshape(-1)
    if big_tiles is not None:
        tile_ids = torch.cat([tile_ids, big_tiles])
        gauss_idx = torch.cat([gauss_idx, big_gauss])
    m = tile_ids.shape[0]
    if exact_sort:
        depth_m = depth[gauss_idx.long()]
        # lexicographic (tile, depth): stable sort by depth, then by tile
        _, p1 = torch.sort(depth_m, stable=True)
        _, p2 = torch.sort(tile_ids[p1], stable=True)
        perm = p1[p2]
        sorted_tile = tile_ids[perm]
    else:
        tile_bits = max(int(n_tiles + 1).bit_length(), 1)
        db = 32 - tile_bits
        dq_g = (depth.clamp_min(0.0).contiguous().view(torch.int32)
                .to(torch.int64) >> (31 - db))  # (N,) quantized depth bits
        key = (tile_ids.to(torch.int64) << db) | dq_g[gauss_idx.long()]
        sorted_key, perm = torch.sort(key, stable=True)
        sorted_tile = (sorted_key >> db).to(torch.int32)
    sorted_gauss = gauss_idx[perm]

    tile_starts = torch.searchsorted(
        sorted_tile,
        torch.arange(n_tiles + 1, dtype=torch.int32, device=dev),
        right=False,
    ).to(torch.int32)

    if needs_inv_perm:
        inv_perm = torch.zeros((m,), dtype=torch.int32, device=dev)
        inv_perm[perm] = torch.arange(m, dtype=torch.int32, device=dev)
    else:
        inv_perm = None

    if pad_to_chunks:
        if needs_inv_perm:
            raise NotImplementedError(
                "pad_to_chunks needs needs_inv_perm=False (tracking path)"
            )
        # chunk-align every segment: padded starts by cumsum of rounded
        # lengths; each padded CHUNK is filled from a CONTIGUOUS run of the
        # sorted slots. Dead gaps (past a segment's real length) and the
        # tail past starts_p[-1] read the dummy record n.
        seg_len = tile_starts[1:] - tile_starts[:-1]
        seg_len_p = ((seg_len + chunk - 1) // chunk) * chunk
        starts_p = torch.cat([
            torch.zeros((1,), dtype=torch.int32, device=dev),
            torch.cumsum(seg_len_p, dim=0).to(torch.int32),
        ])
        m_round = (-(-m // chunk)) * chunk
        raw = m_round + chunk * n_tiles + chunk
        mp_static = (-(-raw // pad_align)) * pad_align
        n_chunks_p = mp_static // chunk
        cstart = torch.arange(n_chunks_p, dtype=torch.int32, device=dev) * chunk
        seg_c = torch.searchsorted(
            starts_p[1:].contiguous(), cstart, right=True
        ).clamp(0, n_tiles - 1)
        off0 = cstart - starts_p[seg_c]  # >= 0 by searchsorted
        rstart = tile_starts[seg_c] + off0  # chunk's first source slot
        lane = torch.arange(chunk, dtype=torch.int32, device=dev)[None, :]
        dead = (off0[:, None] + lane) >= seg_len[seg_c][:, None]
        sg_pad = torch.cat([
            sorted_gauss,
            torch.full((chunk,), n, dtype=sorted_gauss.dtype, device=dev),
        ])
        src = rstart.clamp(0, m)[:, None].long() + lane.long()
        rows = sg_pad[src]  # (n_chunks_p, chunk)
        padded = torch.where(dead, n, rows).to(torch.int32).reshape(-1)
        return Binning(
            pair_gauss=padded,
            tile_starts=starts_p,
            inv_perm=None,
            n_tiles_y=n_ty,
            n_tiles_x=n_tx,
            num_pairs=m,
        )

    # pad so fixed-size chunk reads never run off the end
    m_pad = (-(-m // chunk)) * chunk + chunk
    sorted_gauss = torch.nn.functional.pad(sorted_gauss, (0, m_pad - m))
    return Binning(
        pair_gauss=sorted_gauss,
        tile_starts=tile_starts,
        inv_perm=inv_perm,
        n_tiles_y=n_ty,
        n_tiles_x=n_tx,
        num_pairs=m,
    )
