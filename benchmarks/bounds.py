"""The least time a kernel launch could take on one H100: frozen copies of
`chip_smoke.py`'s peak table and operation counts (lines 199-217), its
`bound` (288), `step_bounds` (542) and the K3 bound of its records-select
check (the entry at 466-469, with `subtile_box_check` at 841 cut to the
box pairs it counts). The plain forms they evaluate are the benchmark's
own frozen copies (plainref/).

A launch's bound is the larger of the bytes its data needs at the HBM
rate and the f32 operations it needs at the CUDA-core rate. Where the
work depends on the data, the count is what these inputs need: the
records each pixel reads until its transmittance is dead (K1, K2), the
(slot, pixel) pairs inside each walked slot's footprint box (K3).
"""

from __future__ import annotations

import torch

from plainref.ops import fused_subtile as fs
from plainref.ops import kcover as kc

# published peaks of one H100 SXM (dense, full power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# floating-point operations per unit of work, counted from csrc/project.cuh
# (one expf counted as 8)
OPS_PROJECT = 67  # project_parts, per slot / record
OPS_COEFF = 22  # coeff_mat, per staged slot
OPS_ALPHA_DIRECT = 32  # K-cover step: sigma at the pixel + compositing
OPS_PAIR_SELECT = 24  # select: polynomial sigma + gates + T update
OPS_CHAIN = 236  # pose_chain, per contributing record


def bound(bytes_moved, ops) -> float:
    """Milliseconds: the larger of bytes / peak bytes/s and operations /
    peak f32 operations/s."""
    t_b = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_o = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_b, t_o)


def step_bounds(kb, cam, n_ty, n_tx, near, far) -> tuple:
    """(K1's bound, K2's bound) in ms of the step at `cam` over the cover
    buffer kb. K1: the records each pixel reads until its transmittance
    is dead, once, and its two rows; one projection and one alpha per
    needed record. K2: the same records, the two cotangent rows and the
    forward's two rows, the 12 scalars; the chain per contributing record
    besides."""
    m_out = kb.shape[2]
    pieces = kc._kcover_fwd_pieces(kb, cam, n_ty, n_tx, near, far)
    live = pieces[5] > kc.T_EPS
    needed = int(live.sum())  # records read until dead
    chained = int((pieces[3] & live).sum())
    del pieces, live
    ops = needed * (OPS_PROJECT + OPS_ALPHA_DIRECT)
    return (bound(needed * 5 * 4 + 2 * 4 * m_out, ops),
            bound(needed * 5 * 4 + 4 * 4 * m_out + 48,
                  ops + chained * OPS_CHAIN))


def box_pairs(p8, meta, n_walk, n_tx, batch=512) -> int:
    """(slot, pixel) pairs inside the `_subtile_box` footprint of the
    first n_walk[s] slots of each segment s (the slots its walk reached),
    taken in 128-slot chunks."""
    n = n_walk.shape[0]
    dev = p8.device
    starts, _ = fs._segment_bounds(meta, n)
    x0, y0 = fs._segment_origins(meta, n, n_tx)
    nw = n_walk.to(dev).long()
    cdl = (nw + fs.CHUNK - 1) // fs.CHUNK
    lane = torch.arange(fs.CHUNK, device=dev)
    total = 0
    for c in range(int(cdl.max()) if n else 0):
        for act in torch.nonzero(c < cdl)[:, 0].split(batch):
            walked = (c * fs.CHUNK + lane[None, :] < nw[act][:, None])
            walked = walked.reshape(-1)
            idx = (starts[act][:, None] + c * fs.CHUNK
                   + lane[None, :]).reshape(-1).clamp_max(p8.shape[1] - 1)
            xa = x0[act].repeat_interleave(fs.CHUNK)
            ya = y0[act].repeat_interleave(fs.CHUNK)
            rec = p8[:, idx]
            coef = fs._coeff_mat(rec, xa[None, :], ya[None, :])
            c_lo, c_hi, r_lo, r_hi = fs._subtile_box(coef, rec[0] - xa,
                                                     rec[1] - ya)
            area = ((c_hi - c_lo + 1).clamp_min(0)
                    * (r_hi - r_lo + 1).clamp_min(0)) * walked
            total += int(area.sum())
    return total


def select_bound(slot3d, meta, cam, n_ty, n_tx, k_cover, near, far) -> float:
    """K3's bound in ms: the walked slots' records read once and projected
    and staged once, each entry of the (5, K, M_out) output written once,
    the segment table; per pair inside the walked slots' boxes the
    select's sigma, gates and transmittance update."""
    stats = {}
    kb = kc._select_records_plain(slot3d, meta, cam, n_ty, n_tx, k_cover,
                                  near, far, stats=stats)
    p8 = fs.project8(slot3d, cam, near, far)
    pairs = box_pairs(p8, meta, stats["seg_slots"], n_tx)
    return bound(stats["slots"] * 5 * 4 + kb.numel() * 4 + meta.numel() * 4,
                 pairs * OPS_PAIR_SELECT
                 + stats["slots"] * (OPS_PROJECT + OPS_COEFF))
