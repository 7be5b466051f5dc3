"""Port vs reference: scene init (kNN scales, SH DC), PCA normalization
and the frame-pair assembler, field by field."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplatloc_tpu.data import parser as jparser
from gsplatloc_tpu.data.synthetic import box_room_frame as j_box_room_frame
from gsplatloc_tpu.models import gaussians as jgauss
from gsplatloc_tpu.ops import knn as jknn
from gsplatloc_tpu.ops import pca as jpca
from gsplatloc_tpu.ops import sh as jsh
from gsplatloc_tpu_torch.data import parser as tparser
from gsplatloc_tpu_torch.data.synthetic import box_room_frame
from gsplatloc_tpu_torch.models import gaussians as tgauss
from gsplatloc_tpu_torch.ops import knn as tknn
from gsplatloc_tpu_torch.ops import pca as tpca
from gsplatloc_tpu_torch.ops import sh as tsh
from helpers import assert_close_except_gate_flips
from torch_port_helpers import (
    assert_rel, intrinsics, perturbed_c2w, to_np, tt,
)


def _grid_cloud(h=32, w=48, seed=0):
    K = intrinsics(h, w)
    _rgb, depth = box_room_frame(np.eye(4), K, h, w, clutter=6)
    u = np.arange(w, dtype=np.float32)[None, :]
    v = np.arange(h, dtype=np.float32)[:, None]
    x = (u - K[0, 2]) / K[0, 0] * depth
    y = (v - K[1, 2]) / K[1, 1] * depth
    return np.stack([x, y, depth], -1).astype(np.float32)


def test_synthetic_frames_are_the_same_in_both_packages():
    K = intrinsics(24, 32)
    c2w = perturbed_c2w((3, -2, 1), (0.1, 0.05, -0.2))
    for kw in ({}, {"clutter": 5}, {"boxes": 3}):
        a = box_room_frame(c2w, K, 24, 32, **kw)
        b = j_box_room_frame(c2w, K, 24, 32, **kw)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("k,window", [(5, 2), (4, 1), (8, 3)])
def test_grid_knn_matches_reference(k, window):
    grid = _grid_cloud()
    dj = jknn.grid_knn_sq_dists(jnp.asarray(grid), k, window)
    dt = tknn.grid_knn_sq_dists(tt(grid), k, window)
    assert tuple(dt.shape) == (grid.shape[0] * grid.shape[1], k)
    assert_rel(dt, dj, 1e-6, "grid knn")
    assert float(dt[:, 0].abs().max()) == 0.0


def test_brute_knn_matches_reference_and_grid_order():
    pts = np.random.default_rng(1).normal(size=(700, 3)).astype(np.float32)
    dj = jknn.brute_knn_sq_dists(jnp.asarray(pts), 5)
    dt = tknn.brute_knn_sq_dists(tt(pts), 5, block=256)
    assert_rel(dt, dj, 1e-5, "brute knn")
    assert bool((dt[:, 1:] >= dt[:, :-1]).all())


@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("q", [0.99, None])
def test_scale_init_matches_reference(quirk, q):
    d2 = to_np(jknn.grid_knn_sq_dists(jnp.asarray(_grid_cloud()), 5, 2))
    sj = jknn.init_gs_scales_from_sq_dists(jnp.asarray(d2),
                                           squared_quirk=quirk,
                                           clamp_quantile=q)
    st = tknn.init_gs_scales_from_sq_dists(tt(d2), squared_quirk=quirk,
                                           clamp_quantile=q)
    assert tuple(st.shape) == (d2.shape[0], 3)
    assert_rel(st, sj, 1e-6, "scales")


def test_quantile_clamp_engages_like_reference():
    """A few 1000x outliers past the 99th percentile are capped, counted,
    and capped to the same value in both packages."""
    rng = np.random.default_rng(2)
    d2 = np.abs(rng.normal(1e-3, 1e-4, size=(2000, 5))).astype(np.float32)
    d2[:, 0] = 0
    d2[:3, 1:] = 30.0
    sj = jknn.init_gs_scales_from_sq_dists(jnp.asarray(d2))
    st = tknn.init_gs_scales_from_sq_dists(tt(d2))
    assert_rel(st, sj, 1e-5, "clamped scales")
    nj = int(jknn.count_clamped_scales(jnp.asarray(d2)))
    nt = tknn.count_clamped_scales(tt(d2))
    assert nt.dtype == torch.int32 and int(nt) == nj == 3
    assert int(tknn.count_clamped_scales(tt(d2[3:]))) == 0


def test_rgb_to_sh_matches_reference():
    rgb = np.random.default_rng(3).random((50, 3)).astype(np.float32)
    np.testing.assert_allclose(to_np(tsh.rgb_to_sh(tt(rgb))),
                               to_np(jsh.rgb_to_sh(jnp.asarray(rgb))),
                               atol=1e-6)
    np.testing.assert_allclose(to_np(tsh.sh_to_rgb(tsh.rgb_to_sh(tt(rgb)))),
                               rgb, atol=1e-6)
    assert tsh.C0 == jsh.C0


@pytest.mark.parametrize("method", ["grid", "brute", "precomputed"])
def test_scene_from_point_cloud_matches_reference(method):
    grid = _grid_cloud(16, 24)
    pts = grid.reshape(-1, 3)
    rgb = np.random.default_rng(4).random(pts.shape).astype(np.float32)
    kw_j, kw_t = {}, {}
    if method == "grid":
        kw_j = kw_t = dict(grid_shape=(16, 24), knn_method="grid")
    elif method == "brute":
        kw_j = kw_t = dict(knn_method="brute")
    else:
        d2 = to_np(jknn.brute_knn_sq_dists(jnp.asarray(pts), 5))
        kw_j = dict(knn_sq_dists=jnp.asarray(d2))
        kw_t = dict(knn_sq_dists=d2)
    sj = jgauss.scene_from_point_cloud(jnp.asarray(pts), jnp.asarray(rgb),
                                       **kw_j)
    st = tgauss.scene_from_point_cloud(pts, rgb, device="cpu", **kw_t)
    assert st.num_gaussians == sj.num_gaussians == pts.shape[0]
    assert st._fields == sj._fields
    for f in sj._fields:
        a, b = to_np(getattr(st, f)), to_np(getattr(sj, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=f)


def test_exact_knn_is_refused_not_replaced(monkeypatch):
    """knn_method='exact' runs the host C++ KdTree (its scales are the
    exact ones, not the grid window's); when that library cannot be built
    it raises — it never falls back to the grid window silently."""
    from gsplatloc_tpu_torch import native

    pts = _grid_cloud(8, 8).reshape(-1, 3)
    exact = tgauss.scene_from_point_cloud(pts, pts, knn_method="exact",
                                          device="cpu")
    brute = tgauss.scene_from_point_cloud(pts, pts, knn_method="brute",
                                          device="cpu")
    np.testing.assert_allclose(to_np(exact.scales), to_np(brute.scales),
                               rtol=1e-6)

    def broken():
        raise RuntimeError("exact-kNN library build failed (test)")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_library", broken)
    with pytest.raises(RuntimeError, match="exact-kNN"):
        tgauss.scene_from_point_cloud(pts, pts, knn_method="exact",
                                      device="cpu")
    p = tparser.Parser("Synthetic", "x", knn_method="exact", device="cpu",
                       n_frames=3, height=8, width=8)
    with pytest.raises(RuntimeError, match="exact-kNN"):
        p[0]


def test_pca_quirks_match_reference():
    """Lower median for even N, N-1 covariance normalization, eigenvector
    order and the determinant sign fix."""
    rng = np.random.default_rng(5)
    pts = (rng.normal(size=(1000, 3)) * [3.0, 1.0, 0.3] + [0.5, -2.0, 4.0]) \
        .astype(np.float32)
    Tj = to_np(jpca.align_principal_axes(jnp.asarray(pts)))
    Tt = to_np(tpca.align_principal_axes(tt(pts)))
    # eigenvector signs are a convention of the eigensolver: rows 2 and 3
    # may flip together (the first row is fixed by the determinant rule)
    for r in range(3):
        s = np.sign(np.dot(Tt[r, :3], Tj[r, :3]))
        np.testing.assert_allclose(Tt[r] * s, Tj[r], atol=2e-5)
    assert np.linalg.det(Tt[:3, :3]) > 0
    med = np.sort(pts, axis=0)[(1000 - 1) // 2]
    np.testing.assert_allclose(Tt[:3, :3] @ med + Tt[:3, 3], 0, atol=1e-5)


def test_transform_cameras_matches_reference():
    rng = np.random.default_rng(6)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = 1.7 * perturbed_c2w((20, -10, 5))[:3, :3]
    T[:3, 3] = [0.1, 0.2, -0.3]
    c2w = np.stack([perturbed_c2w((i, 2 * i, -i), rng.normal(size=3))
                    for i in range(3)]).astype(np.float32)
    cj, sj = jpca.transform_cameras(jnp.asarray(T), jnp.asarray(c2w))
    ct, st = tpca.transform_cameras(tt(T), tt(c2w))
    np.testing.assert_allclose(to_np(ct), to_np(cj), atol=1e-6)
    np.testing.assert_allclose(to_np(st), to_np(sj), atol=1e-6)
    np.testing.assert_allclose(to_np(st), 1.7, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    h, w = 64, 128
    K = intrinsics(h, w)
    tar = np.eye(4, dtype=np.float32)
    tar[:3, 3] = [0.0, 0.0, -1.0]
    src = perturbed_c2w((0.7, -0.4, 0.3), (0.012, -0.01, -0.982))
    f0 = box_room_frame(tar, K, h, w, clutter=8)
    f1 = box_room_frame(src, K, h, w, clutter=8)
    args = (f0[0] * 255.0, f0[1], tar, f1[0] * 255.0, f1[1], src, K)
    out_j = jparser._assemble_pair(
        *[jnp.asarray(a, jnp.float32) for a in args], height=h, width=w,
        normalize=True, backend="subtile")
    out_t = tparser._assemble_pair(*args, height=h, width=w, normalize=True,
                                   backend="subtile", device="cpu")
    return out_j, out_t, args, (h, w)


def _align_signs(out_t, out_j):
    """The PCA frame's 2nd/3rd axes may be mirrored together between two
    eigensolvers; returns the diagonal sign matrix that maps the port's
    frame onto the reference's."""
    a, b = to_np(out_t["tar_c2w"]), to_np(out_j["tar_c2w"])
    s = np.sign(np.sum(a[:3, :3] * b[:3, :3], axis=1))
    return s.astype(np.float32)


@pytest.mark.parametrize("field", ["colors", "pixels", "pca_factor",
                                   "tar_points", "src_points", "tar_c2w",
                                   "src_c2w"])
def test_assemble_pair_field_matches_reference(pair, field):
    out_j, out_t, _args, _hw = pair
    assert set(out_t) == set(out_j)
    a, b = to_np(out_t[field]), to_np(out_j[field])
    assert a.shape == b.shape
    s = _align_signs(out_t, out_j)
    if field in ("tar_points", "src_points"):
        a = a * s[None, :]
    elif field in ("tar_c2w", "src_c2w"):
        a = a.copy()
        a[:3, :] = a[:3, :] * s[:, None]
    # colours / factor: elementwise, 2e-5. Points and poses live in the PCA
    # frame: the box room's two smaller principal variances are close, so
    # the eigenvectors of the f32 covariance (a sum over 8192 points taken
    # in another order) turn by ~1e-5 rad in their plane -> 2e-4 on
    # coordinates of a few metres
    atol = 2e-5 if field in ("colors", "pixels", "pca_factor") else 2e-4
    np.testing.assert_allclose(a, b, atol=atol)


def test_assemble_pair_depth_target_matches_reference(pair):
    """1e-4 on depth where covered — with the gate-flip allowance the
    reference's own cross-implementation comparisons use."""
    out_j, out_t, _args, (h, w) = pair
    d_t, d_j = to_np(out_t["src_depth"]), to_np(out_j["src_depth"])
    assert d_t.shape == d_j.shape == (h, w)
    assert np.isfinite(d_t).all()
    covered = (d_t > 0) & (d_j > 0)
    assert covered.mean() > 0.9
    assert ((d_t > 0) != (d_j > 0)).mean() <= 0.005
    assert_close_except_gate_flips(d_t[covered], d_j[covered], atol=1e-4,
                                   flip_abs=0.3)


def test_assemble_pair_without_normalization_passes_depth_through(pair):
    _oj, _ot, args, (h, w) = pair
    out = tparser._assemble_pair(*args, height=h, width=w, normalize=False,
                                 device="cpu")
    np.testing.assert_array_equal(to_np(out["src_depth"]), args[4])
    assert float(out["pca_factor"]) == 1.0
    np.testing.assert_array_equal(to_np(out["tar_c2w"]), args[2])


def test_render_depth_gt_refuses_unported_backends(pair):
    _oj, out_t, args, (h, w) = pair
    with pytest.raises(NotImplementedError):
        tparser.render_depth_gt(out_t["src_points"], out_t["colors"], args[6],
                                out_t["tar_c2w"], h, w, backend="pallas",
                                device="cpu")


def test_parser_pairs_and_frame_cache():
    p = tparser.Parser("Synthetic", "boxroom", device="cpu", n_frames=5,
                       height=32, width=64)
    assert len(p) == 4
    data = p[0]
    assert data.tar_nums == 32 * 64
    assert tuple(data.src_depth.shape) == (32, 64)
    assert tuple(data.tar_points.shape) == (32 * 64, 3)
    assert bool(torch.isfinite(data.src_depth).all())
    for i in (1, 2, 3):
        p.frame(i)
        p.frame(i + 1)
    assert sorted(p._frame_cache) == [2, 3, 4]
    assert p.knn_for_frame(1) is None
    ref = jparser.Parser("Synthetic", "boxroom", backend="subtile",
                         n_frames=5, height=32, width=64)
    np.testing.assert_allclose(to_np(data.pca_factor),
                               to_np(ref[0].pca_factor), atol=1e-6)
