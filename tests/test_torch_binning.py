"""Port vs reference: tile binning + depth sort. Both sides sort stably,
so the same inputs must give IDENTICAL integer outputs (tile_starts and
sorted gaussian ids) — no tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest

from gsplatloc_tpu.ops import binning as jbin
from gsplatloc_tpu_torch.ops import binning as tbin
from torch_port_helpers import to_np, tt
import torch


def _splats(n=3000, seed=0, big=0, width=256, height=128):
    rng = np.random.default_rng(seed)
    mean2d = np.stack([rng.uniform(-20, width + 20, n),
                       rng.uniform(-20, height + 20, n)], 1).astype(np.float32)
    radius = rng.integers(0, 7, n).astype(np.int32)
    if big:
        radius[rng.choice(n, big, replace=False)] = rng.integers(20, 90, big)
    # quantized depths: plenty of exact ties for the stable-order check
    depth = (rng.integers(1, 400, n) / 100.0).astype(np.float32)
    valid = rng.random(n) > 0.1
    radius = np.where(valid, radius, 0).astype(np.int32)
    return mean2d, radius, depth, valid


def _both(args, width, height, **kw):
    m, r, d, v = args
    bj = jbin.bin_and_sort(jnp.asarray(m), jnp.asarray(r), jnp.asarray(d),
                           jnp.asarray(v), width, height, **kw)
    bt = tbin.bin_and_sort(tt(m), tt(r, torch.int32), tt(d),
                           tt(v, torch.bool), width, height, **kw)
    return bj, bt


def _assert_same(bj, bt):
    assert (bt.n_tiles_y, bt.n_tiles_x, bt.num_pairs) == (
        bj.n_tiles_y, bj.n_tiles_x, bj.num_pairs)
    assert bt.tile_starts.dtype == torch.int32
    assert bt.pair_gauss.dtype == torch.int32
    np.testing.assert_array_equal(to_np(bt.tile_starts), to_np(bj.tile_starts))
    np.testing.assert_array_equal(to_np(bt.pair_gauss), to_np(bj.pair_gauss))
    if bj.inv_perm is None:
        assert bt.inv_perm is None
    else:
        np.testing.assert_array_equal(to_np(bt.inv_perm), to_np(bj.inv_perm))


@pytest.mark.parametrize("exact_sort", [True, False])
@pytest.mark.parametrize("tile", [(16, 128, 2, 2), (16, 16, 2, 2),
                                  (16, 16, 3, 3)])
def test_bin_and_sort_matches_reference(exact_sort, tile):
    th, tw, ky, kx = tile
    bj, bt = _both(_splats(), 256, 128, tile_h=th, tile_w=tw, ky=ky, kx=kx,
                   exact_sort=exact_sort, needs_inv_perm=True)
    _assert_same(bj, bt)


@pytest.mark.parametrize("exact_sort", [True, False])
def test_big_budget_path_matches_reference(exact_sort):
    bj, bt = _both(_splats(big=40, seed=3), 256, 128, tile_h=16, tile_w=16,
                   exact_sort=exact_sort, needs_inv_perm=False,
                   big_budget=64)
    _assert_same(bj, bt)
    assert bt.num_pairs == 3000 * 4 + 64 * (128 // 16) * (256 // 16)


def test_big_budget_smaller_than_big_count_matches_reference():
    """More over-clamp splats than the budget: the top-B by radius (lower
    index first among equals) take the exact path, the rest stay clamped."""
    bj, bt = _both(_splats(big=40, seed=4), 256, 128, tile_h=16, tile_w=16,
                   needs_inv_perm=False, big_budget=8)
    _assert_same(bj, bt)


@pytest.mark.parametrize("pad_align", [128, 8192])
@pytest.mark.parametrize("big_budget", [0, 16])
def test_pad_to_chunks_matches_reference(pad_align, big_budget):
    bj, bt = _both(_splats(big=10, seed=5), 256, 128, tile_h=16, tile_w=16,
                   needs_inv_perm=False, big_budget=big_budget,
                   pad_to_chunks=True, pad_align=pad_align)
    _assert_same(bj, bt)
    starts = to_np(bt.tile_starts)
    assert (starts % 128 == 0).all()
    assert bt.pair_gauss.shape[0] % pad_align == 0
    # dead padding points at the dummy record n
    assert int(bt.pair_gauss.max()) == 3000


def test_unpadded_layout_pads_one_chunk_past_the_end():
    bj, bt = _both(_splats(seed=6), 256, 128, tile_h=16, tile_w=16,
                   needs_inv_perm=False, pad_to_chunks=False)
    _assert_same(bj, bt)
    m = bt.num_pairs
    assert bt.pair_gauss.shape[0] == -(-m // 128) * 128 + 128


def test_segments_are_depth_sorted_and_complete():
    """Within every tile segment depths ascend, and every live emission is
    in exactly one segment."""
    args = _splats(seed=7)
    _bj, bt = _both(args, 256, 128, tile_h=16, tile_w=16, exact_sort=True,
                    needs_inv_perm=False)
    starts = to_np(bt.tile_starts)
    pg = to_np(bt.pair_gauss)
    depth = args[2]
    for t in range(len(starts) - 1):
        seg = depth[pg[starts[t]:starts[t + 1]]]
        assert (np.diff(seg) >= 0).all()
    assert starts[-1] <= bt.num_pairs


def test_stable_ties_keep_emission_order():
    """Equal (tile, depth) keys come out in ascending gaussian order."""
    n = 64
    mean2d = np.full((n, 2), 8.0, np.float32)
    radius = np.ones(n, np.int32)
    depth = np.full(n, 2.0, np.float32)
    valid = np.ones(n, bool)
    for exact in (True, False):
        _bj, bt = _both((mean2d, radius, depth, valid), 32, 16, tile_h=16,
                        tile_w=16, exact_sort=exact, needs_inv_perm=False)
        s = to_np(bt.tile_starts)
        np.testing.assert_array_equal(to_np(bt.pair_gauss)[s[0]:s[1]],
                                      np.arange(n))


@pytest.mark.parametrize("flag", ["big_budget", "pad_to_chunks"])
def test_tracking_only_options_refuse_inv_perm(flag):
    m, r, d, v = _splats(n=32)
    kw = {"big_budget": 4} if flag == "big_budget" else {"pad_to_chunks": True}
    with pytest.raises(NotImplementedError):
        tbin.bin_and_sort(tt(m), tt(r, torch.int32), tt(d), tt(v, torch.bool),
                          256, 128, needs_inv_perm=True, **kw)


def test_radius_clamp_matches_reference():
    for th, ky in ((16, 2), (16, 3), (8, 3)):
        assert tbin.radius_clamp(th, ky) == jbin.radius_clamp(th, ky)
    assert (tbin.TILE_H, tbin.TILE_W) == (jbin.TILE_H, jbin.TILE_W)
