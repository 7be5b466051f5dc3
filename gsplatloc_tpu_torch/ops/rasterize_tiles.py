"""Tiled general rasterizer: the counterpart of the JAX package's
ops/rasterize_pallas.py (its backend "pallas", which the port keeps by
name: here it means the hand-written tiled CUDA kernels).

Gaussians are binned into depth-sorted (16, 128) pixel tiles
(`bin_and_sort`, KY = KX = 2 slots per Gaussian, radius clamp 8 px; the
tile shape and the slot count decide which pixels a large splat reaches,
so they are part of the image, not a tuning knob). Each slot's record is
gathered into a (16, M_pad) field-major buffer:

  0 mean_x, 1 mean_y, 2 conic_a, 3 conic_b, 4 conic_c, 5 depth,
  6 opacity, 7 red, 8 green, 9 blue, 10..15 zero.

Kernels (csrc/rasterize_fwd.cu, csrc/rasterize_bwd.cu), each with its
plain PyTorch version here (and `_footprint_box`, the plain form of the
per-slot pixel box to which both kernels limit their walks):
  rasterize_fwd  replaces the Pallas _fwd_kernel  plain: _composite_fwd_plain
  rasterize_bwd  replaces the Pallas _bwd_kernel  plain: _composite_bwd_plain

The forward composites every tile's segment front to back in 128-slot
chunks, gsplat's gates (sigma >= 0, alpha = min(opa*exp(-sigma), 0.999),
alpha >= 1/255, a slot counts only while T*(1-alpha) > 1e-4), and stops at
the first chunk boundary where no pixel of the tile is alive. The backward
replays that walk and emits per-SLOT gradients of fields 0-9: each slot
column belongs to one tile, so no two tiles write the same column and no
atomics are needed. `gather_slots` folds the slot gradients back per
Gaussian by an inverse-permutation gather and a kmax-way sum.
"""

from __future__ import annotations

import torch

from .. import kernels
from .._device import F32
from .binning import TILE_H, TILE_W, bin_and_sort

NUM_REC_ROWS = 16
N_FIELDS = 10  # record fields the kernels read and gradient rows they write
CHUNK = 128
P = TILE_H * TILE_W  # pixels per tile, flattened row-major
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
T_EPS = 1e-4


def _pixel_xy(n_ty, n_tx, row_offset, device):
    """(n_tiles, P) pixel-centre x and y of every tile, row-major inside."""
    flat = torch.arange(P, device=device)
    row = (flat // TILE_W).to(F32)
    col = (flat % TILE_W).to(F32)
    t = torch.arange(n_ty * n_tx, device=device)
    ti = (t // n_tx + row_offset).to(F32)
    tj = (t % n_tx).to(F32)
    y = row[None, :] + (ti * TILE_H)[:, None] + 0.5
    x = col[None, :] + (tj * TILE_W)[:, None] + 0.5
    return x, y


def _to_tiles(img, n_ty, n_tx):
    """(k, hp, wp) images -> (k, n_tiles, P) tile-major pixel rows."""
    k = img.shape[0]
    return (img.reshape(k, n_ty, TILE_H, n_tx, TILE_W)
            .permute(0, 1, 3, 2, 4).reshape(k, n_ty * n_tx, P))


def _from_tiles(rows, n_ty, n_tx):
    """Inverse of _to_tiles."""
    k = rows.shape[0]
    return (rows.reshape(k, n_ty, n_tx, TILE_H, TILE_W)
            .permute(0, 1, 3, 2, 4).reshape(k, n_ty * TILE_H, n_tx * TILE_W))


def _tile_bounds(meta, n_tiles):
    """Per tile: segment [start, end), the chunk base floor(start/128)*128
    and the number of 128-slot chunks from the base to the end."""
    starts = meta[1:1 + n_tiles].long()
    ends = meta[2:2 + n_tiles].long()
    base = (starts // CHUNK) * CHUNK
    n_chunks = (ends - base + CHUNK - 1) // CHUNK
    return starts, ends, base, n_chunks


def _chunk_alpha(records, col0, starts, ends, px, py):
    """Gated alpha (n, C, P) of one 128-slot chunk of each of n tiles
    (first columns col0 (n,), segments [starts, ends), pixel centres
    px/py (n, P)), with dx, dy (n, C, P), the in-segment mask (n, C) and
    the chunk's record fields (10, n, C). Alpha does not depend on the
    transmittance, so a whole chunk is evaluated at once; the recurrence
    along the slots stays sequential in the callers."""
    idx = col0[:, None] + torch.arange(CHUNK, device=col0.device)  # (n, C)
    rec = records[:N_FIELDS][:, idx]  # (10, n, C)
    mx, my, ca, cb, cc = (rec[k][:, :, None] for k in range(5))
    opa = rec[6][:, :, None]
    dx = px[:, None, :] - mx  # (n, C, P)
    dy = py[:, None, :] - my
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    alpha = torch.clamp_max(opa * torch.exp(-sigma), ALPHA_MAX)
    in_seg = (idx >= starts[:, None]) & (idx < ends[:, None])
    ok = in_seg[:, :, None] & (sigma >= 0.0) & (alpha >= ALPHA_MIN)
    return torch.where(ok, alpha, 0.0), dx, dy, in_seg, rec


# margins of the footprint box (csrc/rasterize.cuh footprint_box says why)
BOX_DET_REL = 2.0 ** -20
BOX_L_REL = 2.0 ** -20
BOX_KAPPA_MAX = 2.0 ** 16
BOX_KAPPA_TERM = 2.0 ** -18
BOX_REL = 2.0 ** -16


def _footprint_box(mx, my, ca, cb, cc, opa, x0, y0):
    """Tile-local pixel box (c_lo, c_hi, r_lo, r_hi), inclusive and clamped
    to the tile, of each slot's alpha-gate footprint: every pixel centre
    outside it gets alpha 0 from `_chunk_alpha`'s gates. The plain form of
    csrc/rasterize.cuh footprint_box, in its f32 operation order (the
    margins and the cases are argued there). mx, my, ca, cb, cc, opa: f32
    tensors of one shape (record fields 0-4 and 6; the full-tile walks'
    projected rows with opacity * ok); x0, y0: the tile's first pixel
    column and row, broadcastable. An empty box is (TILE_W, -1, TILE_H, -1),
    the whole tile (0, TILE_W - 1, 0, TILE_H - 1)."""
    finite = (torch.isfinite(mx) & torch.isfinite(my) & torch.isfinite(ca)
              & torch.isfinite(cb) & torch.isfinite(cc) & torch.isfinite(opa))
    amin = torch.tensor(ALPHA_MIN, dtype=F32)
    k1 = ca * cc
    det_lo = (k1 - cb * cb) - k1 * BOX_DET_REL
    pd = (ca > 0.0) & (cc > 0.0) & (det_lo > 0.0)
    inv_det = 1.0 / det_lo
    kappa = k1 * inv_det
    lf = torch.log(opa * 255.0)
    s = (lf + lf * BOX_L_REL + BOX_L_REL) * (1.0 + kappa * BOX_KAPPA_TERM)
    s2 = 2.0 * s * inv_det
    hx = torch.sqrt(s2 * cc)
    hy = torch.sqrt(s2 * ca)
    ex = hx + hx * BOX_REL + (mx.abs() + x0 + 1.0) * BOX_REL
    ey = hy + hy * BOX_REL + (my.abs() + y0 + 1.0) * BOX_REL
    c_lo = torch.ceil(mx - ex - 0.5 - x0).clamp_min(0.0)
    c_hi = torch.floor(mx + ex - 0.5 - x0).clamp_max(TILE_W - 1.0)
    r_lo = torch.ceil(my - ey - 0.5 - y0).clamp_min(0.0)
    r_hi = torch.floor(my + ey - 0.5 - y0).clamp_max(TILE_H - 1.0)
    whole = ~finite | ~pd | ~(kappa <= BOX_KAPPA_MAX)
    empty = finite & (opa < amin)
    hit = (c_lo <= c_hi) & (r_lo <= r_hi)
    empty = empty | (~whole & ~hit)
    whole = whole & ~empty

    def pick(v, whole_v, empty_v):
        v = torch.where(whole, whole_v, torch.nan_to_num(v))
        return torch.where(empty, empty_v, v).long()

    return (pick(c_lo, 0.0, TILE_W), pick(c_hi, TILE_W - 1.0, -1.0),
            pick(r_lo, 0.0, TILE_H), pick(r_hi, TILE_H - 1.0, -1.0))


# ---------------------------------------------------------------------------
# K6a: forward compositing
# ---------------------------------------------------------------------------

def _composite_fwd_plain(records, meta, n_ty, n_tx, stats=None):
    """Plain PyTorch forward walk: chunk by chunk, the tiles still alive at
    the chunk's entry advance one slot per iteration together (vectorized
    over those tiles and their 2048 pixels, sequential along depth order —
    the kernel's per-pixel recurrence and operation order). Returns (out
    (5, hp, wp) [r, g, b, depth_acc, alpha], chunks_done (n_tiles,) int32
    in 128-slot chunks counted from floor(start/128)*128). Reads the number
    of live tiles back to the host once per chunk. stats (optional dict)
    receives `pairs` (in-segment (slot, pixel) pairs met while the pixel
    was alive) and `hits` (those that passed the alpha gates): the work
    these inputs need."""
    dev = records.device
    n_tiles = n_ty * n_tx
    starts, ends, base, n_chunks = _tile_bounds(meta, n_tiles)
    px, py = _pixel_xy(n_ty, n_tx, meta[0].long(), dev)
    t = torch.ones((n_tiles, P), dtype=records.dtype, device=dev)
    acc = torch.zeros((5, n_tiles, P), dtype=records.dtype, device=dev)
    cd = torch.zeros((n_tiles,), dtype=torch.int32, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    for c in range(int(n_chunks.max()) if n_tiles else 0):
        # chunk-granular early stop: a chunk is walked iff some pixel of
        # the tile is alive at its entry
        act = torch.nonzero(
            (t.max(dim=1).values > T_EPS) & (c < n_chunks))[:, 0]
        if act.numel() == 0:
            break
        cd[act] += 1
        alpha, _dx, _dy, in_seg, rec = _chunk_alpha(
            records, base[act] + c * CHUNK, starts[act], ends[act],
            px[act], py[act])
        ta, aa = t[act], acc[:, act]
        # payload [r, g, b, depth, 1] (n, C); 1 * w == w exactly
        chan = torch.stack([rec[7], rec[8], rec[9], rec[5],
                            torch.ones_like(rec[5])])[..., None]
        one_minus = 1.0 - alpha
        for jj in range(CHUNK):
            a = alpha[:, jj]
            if stats is not None:
                alive = (ta > T_EPS) & in_seg[:, jj:jj + 1]
                pairs += alive.sum()
                hits += (alive & (a > 0.0)).sum()
            t_incl = ta * one_minus[:, jj]
            w = torch.where(t_incl > T_EPS, ta * a, 0.0)
            aa = aa + chan[:, :, jj] * w
            ta = t_incl
        t[act], acc[:, act] = ta, aa
    if stats is not None:
        stats["pairs"], stats["hits"] = int(pairs), int(hits)
    return _from_tiles(acc, n_ty, n_tx), cd


def rasterize_fwd(records, meta, n_ty, n_tx):
    """Front-to-back compositing of every tile's depth-sorted segment.
    records (16, M_pad) f32, meta (n_tiles+2,) int32 = [tile-row offset,
    tile_starts]. Returns (out (5, n_ty*16, n_tx*128) [r, g, b, depth_acc,
    alpha], chunks_done (n_tiles,) int32). CUDA tensor: the hand-written
    kernel (csrc/rasterize_fwd.cu, which replaces the Pallas _fwd_kernel;
    bound by bytes — one block per 16x128 tile, 256 threads of 8 pixels;
    each warp walks the segment on its own, 32 slots at a time, only the
    slots whose footprint box meets its 32x8 pixels, and stops at the first
    128-slot chunk boundary with none of them alive; chunks_done is the
    largest of the warps' stops). CPU tensor: the plain version
    `_composite_fwd_plain`."""
    if not records.is_cuda:
        return _composite_fwd_plain(records, meta, n_ty, n_tx)
    n_tiles = n_ty * n_tx
    mp = records.shape[1]
    kernels.require(records, "records", (NUM_REC_ROWS, mp))
    kernels.require(meta, "meta", (n_tiles + 2,), dtype=torch.int32,
                    device=records.device)
    out = torch.empty((5, n_ty * TILE_H, n_tx * TILE_W), dtype=F32,
                      device=records.device)
    cd = torch.empty((n_tiles,), dtype=torch.int32, device=records.device)
    lib = kernels.load()
    err = lib.gsl_rasterize_fwd(meta.data_ptr(), records.data_ptr(),
                                out.data_ptr(), cd.data_ptr(), n_ty, n_tx,
                                mp, kernels.stream_ptr())
    kernels.check(err, "rasterize_fwd")
    rasterize_fwd.launches += 1
    return out, cd


rasterize_fwd.launches = 0


# ---------------------------------------------------------------------------
# K6b: replay + compositing adjoint -> per-slot gradients
# ---------------------------------------------------------------------------

def _composite_bwd_plain(records, meta, chunks_done, px_in, n_ty, n_tx):
    """Plain PyTorch backward walk over exactly the forward's chunks, with
    the compositing adjoint of the reference's _bwd_kernel, per pixel:

      phi = r*g_r + g*g_g + b*g_b + depth*g_d + g_a;
      run = running sum of w*phi;  suffix = g_tot - run with
      g_tot = sum_ch total_ch*g_ch (the forward totals);
      d_alpha = T_prev*phi - suffix / max(1 - alpha, 1 - ALPHA_MAX), gated
                by live & alpha > 0, and 0 at alpha >= ALPHA_MAX;
      d_sigma = -alpha*d_alpha.

    Per slot, summed over its tile's 2048 pixels in the DIRECT form (no
    moment expansion): s1 = sum d_sigma*dx, s2 = sum d_sigma*dy and the
    three second moments, sum d_alpha*alpha and sum w*g for r, g, b,
    depth. px_in: (10, hp, wp) = the forward's 5 images then the 5
    cotangents. Returns (16, M_pad): rows 0-9 the gradients of fields 0-9
    [d_mx, d_my, d_a, d_b, d_c, d_depth, d_opa, d_r, d_g, d_b], rows
    10-15 zero, and every column the walk does not reach zero."""
    dev = records.device
    n_tiles = n_ty * n_tx
    m_pad = records.shape[1]
    starts, ends, base, _ = _tile_bounds(meta, n_tiles)
    px, py = _pixel_xy(n_ty, n_tx, meta[0].long(), dev)
    rows = _to_tiles(px_in, n_ty, n_tx)  # (10, n_tiles, P)
    tot, gcot = rows[:5], rows[5:]
    g_tot = (gcot[0] * tot[0] + gcot[1] * tot[1] + gcot[2] * tot[2]
             + gcot[3] * tot[3] + gcot[4] * tot[4])
    t = torch.ones((n_tiles, P), dtype=records.dtype, device=dev)
    run = torch.zeros_like(t)
    grad = torch.zeros((NUM_REC_ROWS, m_pad), dtype=records.dtype,
                       device=dev)
    cd = chunks_done.long()
    for c in range(int(cd.max()) if n_tiles else 0):
        act = torch.nonzero(c < cd)[:, 0]
        col0 = base[act] + c * CHUNK
        alpha, dx, dy, in_seg, rec = _chunk_alpha(
            records, col0, starts[act], ends[act], px[act], py[act])
        ta, ra, gt = t[act], run[act], g_tot[act]
        g = gcot[:, act, None, :]  # (5, n, 1, P)
        # what does not depend on the transmittance, for the whole chunk
        # at once (elementwise, so the same values as slot by slot)
        one_minus = 1.0 - alpha
        phi = (rec[7][..., None] * g[0] + rec[8][..., None] * g[1]
               + rec[9][..., None] * g[2] + rec[5][..., None] * g[3]
               + g[4])  # (n, C, P)
        inv_om = 1.0 / torch.clamp_min(one_minus, 1.0 - ALPHA_MAX)
        t_prev = torch.empty_like(alpha)
        suffix = torch.empty_like(alpha)
        wb = torch.empty_like(alpha)
        live = torch.empty(alpha.shape, dtype=torch.bool, device=dev)
        for jj in range(CHUNK):
            t_prev[:, jj] = ta
            t_incl = ta * one_minus[:, jj]
            live[:, jj] = lv = t_incl > T_EPS
            wb[:, jj] = w = torch.where(lv, ta * alpha[:, jj], 0.0)
            ra = ra + w * phi[:, jj]
            suffix[:, jj] = gt - ra
            ta = t_incl
        t[act], run[act] = ta, ra
        d_alpha = t_prev * phi - suffix * inv_om
        d_alpha = torch.where(live & (alpha > 0.0), d_alpha, 0.0)
        d_alpha = torch.where(alpha >= ALPHA_MAX, 0.0, d_alpha)
        ds = d_alpha * (-alpha)
        da = d_alpha * alpha
        s1 = (ds * dx).sum(-1)
        s2 = (ds * dy).sum(-1)
        sxx = (ds * dx * dx).sum(-1)
        sxy = (ds * dx * dy).sum(-1)
        syy = (ds * dy * dy).sum(-1)
        ca, cb, cc = rec[2], rec[3], rec[4]
        vals = torch.stack([
            -(ca * s1 + cb * s2), -(cc * s2 + cb * s1), 0.5 * sxx, sxy,
            0.5 * syy, (wb * g[3]).sum(-1),
            da.sum(-1) / torch.clamp_min(rec[6], 1e-12),
            (wb * g[0]).sum(-1), (wb * g[1]).sum(-1), (wb * g[2]).sum(-1),
        ])  # (10, n, C)
        idx = col0[:, None] + torch.arange(CHUNK, device=dev)
        grad[:N_FIELDS, idx[in_seg]] = vals[:, in_seg]
    return grad


def rasterize_bwd(records, meta, chunks_done, px_in, n_ty, n_tx):
    """Per-slot gradients (16, M_pad) of the forward walk's outputs (see
    `_composite_bwd_plain` for the rows). CUDA tensor: the hand-written
    kernel (csrc/rasterize_bwd.cu, which replaces the Pallas _bwd_kernel;
    bound by bytes — the forward's block shape, each warp walking the
    segment on its own and each slot only over the pixels of its footprint
    box (`_footprint_box`), the 10 per-slot sums reduced per thread, per
    warp by shuffles, then over the warps that met the slot in a fixed
    order, without atomics). CPU tensor: the plain version
    `_composite_bwd_plain`, which walks every pixel."""
    if not records.is_cuda:
        return _composite_bwd_plain(records, meta, chunks_done, px_in,
                                    n_ty, n_tx)
    n_tiles = n_ty * n_tx
    mp = records.shape[1]
    dev = records.device
    kernels.require(records, "records", (NUM_REC_ROWS, mp))
    kernels.require(meta, "meta", (n_tiles + 2,), dtype=torch.int32,
                    device=dev)
    kernels.require(chunks_done, "chunks_done", (n_tiles,),
                    dtype=torch.int32, device=dev)
    kernels.require(px_in, "px_in", (10, n_ty * TILE_H, n_tx * TILE_W),
                    device=dev)
    grad = torch.zeros((NUM_REC_ROWS, mp), dtype=F32, device=dev)
    lib = kernels.load()
    err = lib.gsl_rasterize_bwd(meta.data_ptr(), records.data_ptr(),
                                chunks_done.data_ptr(), px_in.data_ptr(),
                                grad.data_ptr(), n_ty, n_tx, mp,
                                kernels.stream_ptr())
    kernels.check(err, "rasterize_bwd")
    rasterize_bwd.launches += 1
    return grad


rasterize_bwd.launches = 0


class _CompositeTiles(torch.autograd.Function):
    """The 5 composited images of a slot-record buffer, differentiable
    w.r.t. the buffer: forward rasterize_fwd, backward rasterize_bwd."""

    @staticmethod
    def forward(ctx, packed, meta, n_ty, n_tx):
        packed = packed.detach().contiguous()
        out, cd = rasterize_fwd(packed, meta, n_ty, n_tx)
        ctx.save_for_backward(packed, meta, out, cd)
        ctx.grid = (n_ty, n_tx)
        return tuple(out.unbind(0))

    @staticmethod
    def backward(ctx, *cots):
        packed, meta, out, cd = ctx.saved_tensors
        n_ty, n_tx = ctx.grid
        gcot = [torch.zeros_like(out[0]) if g is None else g.to(F32)
                for g in cots]
        px_in = torch.cat([out, torch.stack(gcot)]).contiguous()
        grad = rasterize_bwd(packed, meta, cd, px_in, n_ty, n_tx)
        return grad, None, None, None


def composite_tiles(packed_records, meta, n_ty, n_tx):
    """Composite sorted slot records into tiled images.

    packed_records: (16, M_pad) f32 field rows x sorted slot columns.
    meta: (n_ty*n_tx + 2,) int32 = [tile_row_offset, *tile_starts].
    Returns (r, g, b, depth_acc, alpha), each (n_ty*16, n_tx*128).
    Gradients flow to packed_records per slot."""
    return _CompositeTiles.apply(packed_records, meta, n_ty, n_tx)


class _GatherSlots(torch.autograd.Function):
    """records (N, 16) -> slot buffer (16, M_pad) = records[pair_gauss].T;
    the backward is an INVERSE-PERMUTATION column gather + a kmax-way sum
    (never an index_put with accumulate, whose float atomics sum in thread
    order)."""

    @staticmethod
    def forward(ctx, records, pair_gauss, inv_perm, kmax):
        ctx.save_for_backward(inv_perm)
        ctx.shape = (records.shape[0], kmax)
        return records.detach().T.contiguous().index_select(
            1, pair_gauss.long())

    @staticmethod
    def backward(ctx, cot):
        (inv_perm,) = ctx.saved_tensors
        n, kmax = ctx.shape
        per_pair = cot.index_select(1, inv_perm.long())  # (16, M) pair order
        grad = per_pair.reshape(NUM_REC_ROWS, n, kmax).sum(dim=2).T
        return grad, None, None, None


def gather_slots(records, pair_gauss, inv_perm, kmax: int):
    """Per-Gaussian records (N, 16) -> sorted slot buffer (16, M_pad)."""
    return _GatherSlots.apply(records, pair_gauss, inv_perm, kmax)


def pack_slots(mean2d, conic, depth, opacity, colors, valid, radius,
               width: int, height: int):
    """Bin the projected splats into depth-sorted (16, 128) tiles and
    gather their records into the slot buffer. Returns (packed (16, M_pad),
    meta (n_tiles+2,) int32 = [0, *tile_starts], binning); packed is
    differentiable w.r.t. every record field (gather_slots)."""
    n = mean2d.shape[0]
    binning = bin_and_sort(
        mean2d.detach(), radius, depth.detach(), valid, width, height,
        tile_h=TILE_H, tile_w=TILE_W, chunk=CHUNK,
    )
    colors3 = colors if colors.shape[1] else torch.zeros(
        (n, 3), dtype=mean2d.dtype, device=mean2d.device)
    rows = [
        mean2d[:, 0], mean2d[:, 1],
        conic[:, 0], conic[:, 1], conic[:, 2],
        depth, opacity,
        colors3[:, 0], colors3[:, 1], colors3[:, 2],
    ]
    records = torch.stack(
        rows + [torch.zeros_like(depth)] * (NUM_REC_ROWS - len(rows)), dim=1)
    kmax = binning.inv_perm.shape[0] // max(n, 1)
    packed = gather_slots(records, binning.pair_gauss, binning.inv_perm, kmax)
    meta = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=mean2d.device),
        binning.tile_starts,
    ])
    return packed, meta, binning


def rasterize_tiles(
    mean2d: torch.Tensor,  # (N, 2)
    conic: torch.Tensor,  # (N, 3)
    depth: torch.Tensor,  # (N,)
    opacity: torch.Tensor,  # (N,)
    colors: torch.Tensor,  # (N, C) C in {0, 3}
    valid: torch.Tensor,  # (N,) bool
    radius: torch.Tensor,  # (N,) int32
    width: int,
    height: int,
    mesh=None,
):
    """Tile-binned render. Returns (image (H, W, C+1), alpha (H, W)); the
    last image channel is the UNNORMALIZED accumulated depth (the caller
    divides by alpha, ops/rasterize.py). With a TileMesh
    (parallel/sharded.py) the tile rows composite in bands over its
    devices (n_ty padded to the band count) and the record gradients are
    summed in band order."""
    if mesh is not None:
        from ..parallel.sharded import (
            _check_mesh, _pad_starts, sharded_composite,
        )

        d = _check_mesh(mesh)
    packed, meta, binning = pack_slots(
        mean2d, conic, depth, opacity, colors, valid, radius, width, height)
    n_ty, n_tx = binning.n_tiles_y, binning.n_tiles_x
    if mesh is None:
        r, g, b, d_acc, alpha = composite_tiles(packed, meta, n_ty, n_tx)
    else:
        n_ty_pad = -(-n_ty // d) * d  # padded rows are empty tiles
        starts = _pad_starts(meta[1:], (n_ty_pad - n_ty) * n_tx)
        r, g, b, d_acc, alpha = sharded_composite(packed, starts, n_ty_pad,
                                                  n_tx, mesh)
    if colors.shape[1] == 0:
        image = d_acc[:height, :width, None]
    else:
        image = torch.stack(
            [r[:height, :width], g[:height, :width], b[:height, :width],
             d_acc[:height, :width]], dim=-1)
    return image, alpha[:height, :width]
