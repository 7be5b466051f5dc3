"""Port vs reference: the evaluation extras of the port (image metrics,
LPIPS, the normal-consistency loss, the grid scale init and the outlier
mask, the profiling hooks, the runner's panels and the plot functions),
the same numpy inputs through both packages on the CPU."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplatloc_tpu import losses as jlosses
from gsplatloc_tpu.eval import lpips as jlpips
from gsplatloc_tpu.ops import filters as jfilters
from gsplatloc_tpu.ops import knn as jknn
from gsplatloc_tpu_torch import losses as tlosses
from gsplatloc_tpu_torch.convert import lpips_params_from_numpy
from gsplatloc_tpu_torch.eval import lpips as tlpips
from gsplatloc_tpu_torch.eval import visualize as tvis
from gsplatloc_tpu_torch.ops import filters as tfilters
from gsplatloc_tpu_torch.ops import knn as tknn
from gsplatloc_tpu_torch.utils import profiling
from torch_port_helpers import assert_rel, intrinsics, to_np, tt

RNG_SEED = 0


def _images(shape, seed=RNG_SEED):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return a, b


# ------------------------------------------------------------ psnr / ssim
@pytest.mark.parametrize("shape", [(40, 56, 3), (40, 56)], ids=["hwc", "hw"])
def test_psnr_and_ssim_match_the_reference(shape):
    """f32 in both: PSNR within 1e-5 dB relative; SSIM, a mean of ratios
    of blurred moments whose 11-tap sums run in another order, within
    1e-5 absolute."""
    a, b = _images(shape)
    assert_rel(tfilters.psnr(tt(a), tt(b)), jfilters.psnr(a, b), 1e-6, "psnr")
    got = float(tfilters.ssim(tt(a), tt(b)))
    want = float(jfilters.ssim(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) <= 1e-5, (got, want)
    # identical images: SSIM 1 to within f32 rounding, PSNR at its cap
    assert abs(float(tfilters.ssim(tt(a), tt(a))) - 1.0) <= 1e-5
    assert float(tfilters.psnr(tt(a), tt(a))) == pytest.approx(200.0)


def test_ssim_kernel_is_the_references():
    for size, sigma in ((11, 1.5), (7, 1.0)):
        k_t = tfilters._gaussian_kernel1d(size, sigma, "cpu")
        k_j = jfilters._gaussian_kernel1d(size, sigma)
        np.testing.assert_array_equal(to_np(k_t), np.asarray(k_j))


# ------------------------------------------------------------ LPIPS
def test_random_lpips_params_are_the_references():
    """The same seed draws the same weights, bit for bit."""
    p_t = tlpips.random_lpips_params(3, device="cpu")
    p_j = jlpips.random_lpips_params(3)
    for (wt, bt), (wj, bj) in zip(p_t["convs"], p_j["convs"]):
        np.testing.assert_array_equal(to_np(wt), np.asarray(wj))
        np.testing.assert_array_equal(to_np(bt), np.asarray(bj))
    for lt, lj in zip(p_t["lins"], p_j["lins"]):
        np.testing.assert_array_equal(to_np(lt), np.asarray(lj))


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batch"])
def test_lpips_matches_the_reference(batched):
    """The JAX weights carried across (convert.lpips_params_from_numpy);
    64x64 images. Convolutions over up to 3,456 products summed in
    another order: within 1e-4 relative."""
    params_j = jlpips.random_lpips_params(0)
    params_t = lpips_params_from_numpy(
        {"convs": [(np.asarray(w), np.asarray(b))
                   for w, b in params_j["convs"]],
         "lins": [np.asarray(w) for w in params_j["lins"]]}, device="cpu")
    shape = (2, 64, 64, 3) if batched else (64, 64, 3)
    a, b = _images(shape, seed=1)
    got = tlpips.lpips(tt(a), tt(b), params_t)
    want = jlpips.lpips(jnp.asarray(a), jnp.asarray(b), params_j)
    assert got.shape == tuple(np.shape(want))
    assert_rel(got, want, 1e-4, "lpips")
    assert float(tlpips.lpips(tt(a), tt(a), params_t).abs().max()) == 0.0


def test_load_lpips_params_round_trip(tmp_path):
    params = tlpips.random_lpips_params(1, device="cpu")
    arrays = {}
    for i, (w, b) in enumerate(params["convs"]):
        arrays[f"conv{i}_w"] = to_np(w)
        arrays[f"conv{i}_b"] = to_np(b)
    for i, w in enumerate(params["lins"]):
        arrays[f"lin{i}_w"] = to_np(w)
    np.savez(tmp_path / "alex.npz", **arrays)
    back = tlpips.load_lpips_params(str(tmp_path / "alex.npz"), device="cpu")
    for (w0, b0), (w1, b1) in zip(params["convs"], back["convs"]):
        assert torch.equal(w0, w1) and torch.equal(b0, b1)
    for w0, w1 in zip(params["lins"], back["lins"]):
        assert torch.equal(w0, w1)
    # the JAX package reads the same file to the same numbers
    back_j = jlpips.load_lpips_params(str(tmp_path / "alex.npz"))
    np.testing.assert_array_equal(to_np(back["convs"][4][0]),
                                  np.asarray(back_j["convs"][4][0]))


# ------------------------------------------------------------ losses, knn
def _depths(h=24, w=32):
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 2.0 + 0.01 * xx + 0.02 * yy
    a = (base + 0.01 * rng.standard_normal((h, w))).astype(np.float32)
    b = (base + 0.03 * np.sin(xx / 3.0)).astype(np.float32)
    return a, b, intrinsics(h, w)


@pytest.mark.parametrize("loss_type", ["cosine", "l1", "mse"])
def test_normal_consistency_loss_matches_the_reference(loss_type):
    """Unit normals from the same cross products; within 1e-5 relative."""
    a, b, K = _depths()
    got = tlosses.normal_consistency_loss(tt(a), tt(b), tt(K), loss_type)
    want = jlosses.normal_consistency_loss(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(K), loss_type)
    assert_rel(got, want, 1e-5, loss_type)


def _grid_cloud(h=20, w=28):
    from gsplatloc_tpu_torch.ops.camera import depth_to_points

    d, _, K = _depths(h, w)
    return to_np(depth_to_points(tt(d), tt(K))).reshape(h, w, 3)


def test_init_gs_scales_grid_matches_the_reference():
    """Grid-window kNN + the squared-distance scale formula: the kNN
    distances are the same f32 sums, the scales within 1e-6 relative."""
    grid = _grid_cloud()
    got = tknn.init_gs_scales_grid(tt(grid))
    want = jknn.init_gs_scales_grid(jnp.asarray(grid))
    assert got.shape == (grid.shape[0] * grid.shape[1], 3)
    assert_rel(got, want, 1e-6, "scales")


@pytest.mark.parametrize("given", [False, True], ids=["brute", "given"])
def test_remove_outliers_matches_the_reference(given):
    """The same inlier mask and a threshold within 1e-5 relative, with
    kNN brute force in each package or the same distances given."""
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((300, 3)).astype(np.float32)
    pts[0] = 1000.0  # one far outlier
    d2 = np.asarray(jknn.brute_knn_sq_dists(jnp.asarray(pts), 10)) \
        if given else None
    m_t, thr_t = tknn.remove_outliers(
        tt(pts), None if d2 is None else tt(d2))
    m_j, thr_j = jknn.remove_outliers(
        jnp.asarray(pts), None if d2 is None else jnp.asarray(d2))
    np.testing.assert_array_equal(to_np(m_t), np.asarray(m_j))
    assert not to_np(m_t)[0] and to_np(m_t)[1:].all()
    assert_rel(thr_t, thr_j, 1e-5, "threshold")


# ------------------------------------------------------------ profiling
def test_time_block_and_timer_stats():
    profiling.reset_timers()
    for _ in range(3):
        with profiling.time_block("unit") as tb:
            y = tb.watch(torch.ones(64, 64) @ torch.ones(64, 64))
    assert float(y[0, 0]) == 64.0
    st = profiling.timer_stats("unit")
    assert st["count"] == 3 and 0.0 < st["min_s"] <= st["mean_s"]
    assert st["total_s"] == pytest.approx(3 * st["mean_s"])
    assert profiling.timer_stats("never") == {}
    profiling.reset_timers()
    assert profiling.timer_stats("unit") == {}


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    import json

    with profiling.profile_trace(tmp_path / "trace", device="cpu") as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    trace = json.loads((tmp_path / "trace" / profiling.TRACE_FILE)
                       .read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names
    assert any(e.key in ("aten::mm", "aten::matmul")
               for e in prof.key_averages())


def test_profile_trace_on_the_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        with profiling.profile_trace(tmp_path):
            pass


# ------------------------------------------------------------ figures
def test_runner_writes_panels_and_pcd_pngs(tmp_path):
    """SequenceRunner(panel_every=1, pcd_every=1) writes a panel and a 3D
    inspection PNG per pair, as the reference's runner does."""
    from gsplatloc_tpu_torch.data.png import SIGNATURE
    from gsplatloc_tpu_torch.opt.tracking import TrackingConfig
    from gsplatloc_tpu_torch.tracking.runner import SequenceRunner

    r = SequenceRunner(
        data_set="Synthetic", scene_name="", normalize=True,
        backend="reference",
        config=TrackingConfig(max_steps=10, patience=10, warmup_steps=2),
        run_dir=tmp_path / "run", max_pairs=2, panel_every=1, pcd_every=1,
        knn_method="grid", device="cpu", n_frames=3, height=32, width=48,
    )
    r.train(progress=False, checkpoint_every=0)
    for sub in ("panels", "pcd"):
        pngs = sorted((tmp_path / "run" / sub).glob("pair_*.png"))
        assert [p.name for p in pngs] == ["pair_00000.png", "pair_00001.png"]
        assert all(p.read_bytes().startswith(SIGNATURE) for p in pngs)


def test_without_matplotlib_the_figures_raise_naming_it(monkeypatch):
    """Where matplotlib is missing (the card's machine) a plot function,
    and a runner asked for panels, raise an ImportError that names it —
    the runner at construction, not at its first pair."""
    from gsplatloc_tpu_torch.tracking.runner import SequenceRunner

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tvis.plot_bar(["a"], [1.0], "never.png")
    for kw in ({"panel_every": 1}, {"pcd_every": 2}):
        with pytest.raises(ImportError, match="matplotlib"):
            SequenceRunner("Synthetic", "", device="cpu", knn_method="grid",
                           n_frames=3, height=8, width=8, **kw)
    # the depth colormap needs none
    assert tvis.depth_to_colormap(np.ones((4, 4))).shape == (4, 4, 3)


@pytest.mark.parametrize("plot", ["rgbd_panel", "trajectory", "bar",
                                  "error_series", "point_cloud",
                                  "pcd_inspector"])
def test_plot_functions_write_pngs(tmp_path, plot):
    rng = np.random.default_rng(5)
    d_gt, d_r, K = _depths()
    poses = np.stack([np.eye(4)] * 3)
    poses[:, 0, 3] = [0.0, 0.1, 0.2]
    pts = rng.standard_normal((500, 3))
    out = tmp_path / f"{plot}.png"
    if plot == "rgbd_panel":
        rgb = rng.random(d_gt.shape + (3,))
        p = tvis.plot_rgbd_panel(d_gt, d_r, out, rgb_gt=rgb,
                                 rgb_rendered=rgb * 0.9, title="pair 0")
    elif plot == "trajectory":
        p = tvis.plot_trajectory(poses, out, poses_gt=poses * 1.01)
    elif plot == "bar":
        p = tvis.plot_bar(["room0", "room1"], [0.1, 0.2], out, title="ATE",
                          ylabel="cm")
    elif plot == "error_series":
        p = tvis.plot_error_series({"eT": [1, 2, 3], "eR": [3, 2, 1]}, out)
    elif plot == "point_cloud":
        p = tvis.visualize_point_cloud(pts, out, colors=rng.random((500, 3)),
                                       poses={"a": poses[0], "b": poses[2]},
                                       K=K, wh=(32, 24), title="cloud")
    else:
        insp = tvis.PcdInspector(K, wh=(32, 24), points_per_update=200)
        assert insp.save(out) is None  # nothing yet
        for i in range(3):
            insp.update(pts, poses[i], colors=rng.random((500, 3)))
        p = insp.save(out, title="map")
    assert p == out and out.stat().st_size > 1000
