"""The reduction order of the sub-tile pose chain K5b (csrc/subtile_bwd.cu
subtile_chain_kernel), held where no kernel can run. A float32 emulation
of the kernel — per-slot partials in f32 (origin decoded from moment row
7, the projection and the chain from +0), summed in double in its fixed
order: CHAIN_BLOCKS contiguous shares of whole 256-slot rows of the walked
range [meta[1], meta[-1]), each thread's slots in slot order, a shuffle
tree per warp, the warps in order, and the blocks' rows lane-strided then
by a shuffle tree — must lie within 1e-4 of the plain version `_chain_xla`
and of a float64 replay, on the sub-tile scenes of
test_torch_subtile_bwd.py (the port's own moments of those scenes). The
kernel skips the slots outside the walked range and the all-zero moment
columns: their partials are signed zeros, so the skip changes no bit."""

import numpy as np
import pytest
import torch

from gsplatloc_tpu_torch import kernels
from gsplatloc_tpu_torch.ops import fused_subtile as tfs
from gsplatloc_tpu_torch.ops import fused_tracking as tft
from test_torch_subtile_bwd import _port_backward, _reference_backward
from torch_port_helpers import tt

TOL_REL = 1e-4
N_LANES = 32
N_WARPS = kernels.REDUCE_THREADS // N_LANES


def _slot_parts(slot3d, mom, cam):
    """(12, n) f32 partials of the given slots, as a kernel thread forms
    each from its moments (the origin decoded from row 7)."""
    enc = mom[7]
    ty = torch.floor(enc * (1.0 / tfs.ENC_Y))
    x0 = (enc - tfs.ENC_Y * ty) * tfs.SUB_W
    y0 = ty * tfs.SUB_H
    pr = tft._project_slots(slot3d, cam)
    maps = tft._pose_chain(pr, *(mom[r] for r in range(7)), x0, y0, cam[0],
                           cam[1], reduce=False)
    return torch.stack([0.0 + m for m in maps]).reshape(12, -1)


def _tree(v):
    """Lane 0 of a shuffle-down tree over the last axis (32 lanes)."""
    for ofs in (16, 8, 4, 2, 1):
        v = v[..., :ofs] + v[..., ofs:2 * ofs]
    return v[..., 0]


def _kernel_sum(parts):
    """(1, 16) f32 sum of the (12, n) partials of the walked range's slots
    in the kernel's order, in double."""
    blocks, threads = kernels.CHAIN_BLOCKS, kernels.REDUCE_THREADS
    n = parts.shape[1]
    share = -(-(-(-n // threads)) // blocks) * threads
    p = torch.zeros((12, blocks * share), dtype=torch.float64)
    p[:, :n] = parts.double()
    p = p.reshape(12, blocks, share // threads, threads)
    acc = torch.zeros((12, blocks, threads), dtype=torch.float64)
    for k in range(share // threads):  # each thread's slots in slot order
        acc = acc + p[:, :, k]
    warps = _tree(acc.reshape(12, blocks, N_WARPS, N_LANES))
    rows = torch.zeros((12, blocks), dtype=torch.float64)
    for w in range(N_WARPS):
        rows = rows + warps[:, :, w]
    lanes = torch.zeros((12, N_LANES), dtype=torch.float64)
    for r in range(-(-blocks // N_LANES)):
        idx = torch.arange(N_LANES) + N_LANES * r
        keep = idx < blocks
        lanes[:, keep] = lanes[:, keep] + rows[:, idx[keep]]
    d = _tree(lanes).float()
    return torch.cat([d, torch.zeros(4)]).reshape(1, 16)


def _emulated_chain(slot3d, mom, cam, meta, skip=True):
    """The kernel's result: the walked range only, all-zero moment columns
    skipped (or, skip=False, chained and added like any other)."""
    lo, hi = int(meta[1]), int(meta[-1])
    parts = _slot_parts(slot3d[:, lo:hi], mom[:, lo:hi], cam)
    if skip:
        parts = torch.where((mom[:7, lo:hi] != 0).any(dim=0), parts, 0.0)
    return _kernel_sum(parts)


@pytest.fixture(scope="module", params=[1.0, 0.55], ids=["opa1", "opa055"])
def scene(request):
    """A sub-tile scene of test_torch_subtile_bwd.py with the moments the
    port's backward made for it."""
    ref = _reference_backward(request.param)
    _grad, seen = _port_backward(ref)
    return (tt(ref["slot"]), seen["mom"], tt(ref["cam"]),
            tt(ref["meta"], torch.int32))


def _rel(d, ref):
    return float((d.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


def test_kernel_order_is_within_tolerance_of_plain_and_float64(scene):
    slot3d, mom, cam, meta = scene
    d = _emulated_chain(slot3d, mom, cam, meta)
    plain = tfs._chain_xla(slot3d, mom, cam, meta, 1)
    d64 = tfs._chain_xla(slot3d.double(), mom.double(), cam.double(), meta,
                         1)
    assert float(plain[0, :12].abs().max()) > 0.0
    assert _rel(d, plain) <= TOL_REL, _rel(d, plain)
    assert _rel(d, d64) <= TOL_REL, _rel(d, d64)
    assert torch.equal(d[0, 12:], torch.zeros(4))


def test_skipped_slots_change_no_bit(scene):
    slot3d, mom, cam, meta = scene
    lo, hi = int(meta[1]), int(meta[-1])
    zero = ~(mom[:7] != 0).any(dim=0)
    assert bool(zero[lo:hi].any())  # the scene has zero columns to skip
    # the all-zero columns inside the walked range, chained anyway
    assert torch.equal(_emulated_chain(slot3d, mom, cam, meta, skip=False),
                       _emulated_chain(slot3d, mom, cam, meta))
    # every column, outside the range with its moments masked to zero as
    # the plain version masks them: the skipped ones hold signed zeros
    idx = torch.arange(mom.shape[1])
    inside = (idx >= lo) & (idx < hi)
    parts = _slot_parts(slot3d, torch.where(inside, mom, 0.0), cam)
    skipped = ~inside | zero
    assert bool(skipped.any()) and bool((parts[:, skipped] == 0.0).all())
    # so a sum in slot order over every column equals the walked slots'
    full = torch.zeros(12, dtype=torch.float64)
    kept = torch.zeros(12, dtype=torch.float64)
    for i in range(mom.shape[1]):
        full = full + parts[:, i].double()
        if not skipped[i]:
            kept = kept + parts[:, i].double()
    assert torch.equal(full, kept)


def test_shares_cover_the_walked_range_once():
    """Every slot of the walked range falls in exactly one thread's list,
    in slot order, for ranges short and long against the grid."""
    blocks, threads = kernels.CHAIN_BLOCKS, kernels.REDUCE_THREADS
    for n in (0, 1, 255, 256, 257, blocks * threads - 1,
              blocks * threads + 1, 3 * blocks * threads + 77):
        share = -(-(-(-n // threads)) // blocks) * threads
        b0 = np.arange(blocks) * share
        b1 = np.minimum(b0 + share, n)
        seen = np.concatenate([np.arange(a, b) for a, b in zip(b0, b1)
                               if b > a] or [np.zeros(0, int)])
        assert np.array_equal(seen, np.arange(n)), n
