"""Port vs reference: the novel-view fly-through (`cli render`) and what it
is built from — the camera paths (data/traj.py), the depth colormap and
the PNG panels without matplotlib, one path view through the general
rasterizer — and the live viewer, the same inputs through both packages
on the CPU at 48x64."""

import importlib
import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gsplatloc_tpu.cli import main as jmain
from gsplatloc_tpu.data import traj as jtraj
from gsplatloc_tpu.eval import visualize as jvis
from gsplatloc_tpu_torch import cli
from gsplatloc_tpu_torch.convert import scene_from_numpy
from gsplatloc_tpu_torch.data import png
from gsplatloc_tpu_torch.data import traj as ttraj
from gsplatloc_tpu_torch.eval import render_compare
from gsplatloc_tpu_torch.eval import visualize as tvis
from torch_port_helpers import to_np

H, W = 48, 64
# per pixel, port vs JAX package on the same scene and pose: the same f32
# projection and compositing in another operation order; colour and alpha
# absolute, expected depth relative
TOL_PIXEL = 1e-5


def _poses(n=6, seed=0):
    """A smooth trajectory with some rotation: (n, 4, 4) float64."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        out[i, :3, :3] = Rotation.from_euler(
            "xyz", rng.normal(scale=8.0, size=3), degrees=True).as_matrix()
        out[i, :3, 3] = [0.3 * i, 0.1 * np.sin(i), 1.0 + 0.05 * i]
    return out


# ------------------------------------------------------------ traj
@pytest.mark.parametrize("case", ["normalize", "viewmatrix", "focus_point",
                                  "ellipse_z", "ellipse_y", "bspline_basis",
                                  "spline_look_at", "spline_keyframes",
                                  "spline_one_pose"])
def test_traj_paths_bit_equal(case):
    poses = _poses()
    v = np.array([0.3, -1.2, 2.5])

    def run(mod):
        if case == "normalize":
            return mod.normalize(v)
        if case == "viewmatrix":
            return mod.viewmatrix(v, np.array([0.0, 1.0, 0.0]), -v)
        if case == "focus_point":
            return mod.focus_point_fn(poses)
        if case == "ellipse_z":
            return mod.generate_ellipse_path_z(poses, 17, 0.5, 0.25)
        if case == "ellipse_y":
            return mod.generate_ellipse_path_y(poses, 17, 0.5, 0.25)
        if case == "bspline_basis":
            return mod._bspline_basis(np.linspace(0, 1, 9))
        if case == "spline_look_at":
            return mod.generate_interpolated_path(poses, 5)
        if case == "spline_keyframes":
            return mod.generate_interpolated_path(poses, 4,
                                                  look_at_neighbor=False)
        return mod.generate_interpolated_path(poses[:1], 4)

    got, want = run(ttraj), run(jtraj)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ colormap
def _depth_case(case):
    rng = np.random.default_rng(1)
    if case == "random_with_zeros":
        d = rng.uniform(0.5, 4.0, (H, W))
        d[rng.random((H, W)) < 0.2] = 0.0
        d[0, 0] = -1.0
        return d.astype(np.float32)
    if case == "constant":
        return np.full((H, W), 2.5, np.float32)
    if case == "norm_one":  # exact range ends: norm 0 and norm 1
        d = np.linspace(1.0, 3.0, H * W).reshape(H, W)
        d[5, 7] = 3.0
        return d
    if case == "all_invalid":
        return np.zeros((H, W), np.float32)
    # every lookup index: norm on and around each k / 256
    k = np.arange(257) / 256.0
    d = np.concatenate([k, np.nextafter(k, 2), np.nextafter(k, -1)])
    return np.clip(d, 0, 1)[None, :] + 1.0


@pytest.mark.parametrize("case", ["random_with_zeros", "constant",
                                  "norm_one", "all_invalid", "every_index"])
def test_depth_to_colormap_bit_equal(case):
    """The table lookup against matplotlib's colormap, uint8 for uint8."""
    d = _depth_case(case)
    got = tvis.depth_to_colormap(d)
    want = jvis.depth_to_colormap(d)
    assert got.dtype == np.uint8 and got.shape == d.shape + (3,)
    np.testing.assert_array_equal(got, want)


def test_viridis_table_is_matplotlibs():
    import matplotlib.pyplot as plt

    from gsplatloc_tpu_torch.eval.viridis import VIRIDIS

    cmap = plt.get_cmap("viridis")
    lut = cmap(np.arange(256))[:, :3]
    np.testing.assert_array_equal(np.asarray(VIRIDIS), lut)


def test_panel_png_decodes_as_imsave(tmp_path):
    """A panel written by the port (data/png.py, BGR in) decodes (PIL) to
    the RGB of `plt.imsave` of the same array (which writes RGBA)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(2)
    render = np.concatenate([rng.uniform(-0.1, 1.1, (H, W, 3)),
                             _depth_case("random_with_zeros")[..., None]],
                            axis=-1).astype(np.float32)
    panel = cli.render_panel(render)
    assert panel.shape == (H, 2 * W, 3) and panel.dtype == np.uint8
    png.imwrite(tmp_path / "port.png", panel[..., ::-1])
    plt.imsave(tmp_path / "mpl.png", panel)
    got = np.asarray(Image.open(tmp_path / "port.png"))
    want = np.asarray(Image.open(tmp_path / "mpl.png"))
    assert got.shape == (H, 2 * W, 3) and want.shape == (H, 2 * W, 4)
    np.testing.assert_array_equal(got, want[..., :3])
    # and the port's own decoder reads its file back (as BGR)
    np.testing.assert_array_equal(png.imread(tmp_path / "port.png"),
                                  panel[..., ::-1])


# ------------------------------------------------------------ the CLI
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """`cli render` at 48x64, 2 views asked (11 written), in both packages,
    every view's render and alpha recorded as each rasterizer returned
    them."""
    root = tmp_path_factory.mktemp("render")
    argv = ["render", "--dataset", "Synthetic", "--height", str(H),
            "--width", str(W), "--n-views", "2", "--path", "spline"]
    got, want = [], []
    view = cli.render_view

    def recording_view(*a, **k):
        render, alpha = view(*a, **k)
        got.append((to_np(render), to_np(alpha)))
        return render, alpha

    jrast = importlib.import_module("gsplatloc_tpu.ops.rasterize")
    rasterize = jrast.rasterize

    def recording_rasterize(*a, **k):
        render, alpha = rasterize(*a, **k)
        want.append((np.asarray(render), np.asarray(alpha)))
        return render, alpha

    try:
        cli.render_view = recording_view
        cli.main(argv + ["--device", "cpu", "--out", str(root / "port")])
        jrast.rasterize = recording_rasterize
        jmain(["--platform", "cpu"] + argv + ["--out", str(root / "jax")])
    finally:
        cli.render_view = view
        jrast.rasterize = rasterize
    return dict(root=root, got=got, want=want)


def test_cli_render_flythrough(runs):
    """The reference test's assertions on the port's panels."""
    views = sorted((runs["root"] / "port").glob("view_*.png"))
    assert len(views) >= 2
    img = np.asarray(Image.open(views[0]))
    assert img.shape[0] == H and img.shape[1] == 2 * W
    assert img[..., :3].max() > 0  # not a blank render


def test_cli_render_views_match_the_jax_cli(runs):
    """Every view of the port's `cli render --device cpu` against the JAX
    CLI's: the same count, every pixel within TOL_PIXEL (ED relative), the
    record's summaries (render_compare) within it too, and the panels'
    RGB halves within one level of 255 (truncation of values that differ
    in the last bits)."""
    got, want = runs["got"], runs["want"]
    assert len(got) == len(want) == 11
    for i, ((r_t, a_t), (r_j, a_j)) in enumerate(zip(got, want)):
        assert r_t.shape == (H, W, 4) and a_t.shape == (H, W)
        assert np.abs(r_t[..., :3] - r_j[..., :3]).max() <= TOL_PIXEL, i
        assert np.abs(a_t - a_j).max() <= TOL_PIXEL, i
        ed_rel = np.abs(r_t[..., 3] - r_j[..., 3]) / np.maximum(
            np.abs(r_j[..., 3]), 1e-30)
        assert ed_rel.max() <= TOL_PIXEL, i
    record = {"views": len(want),
              "per_view": [render_compare.summarize(r, a, blocks=False)
                           for r, a in want],
              "blocks": {str(i): render_compare.summarize(*want[i])["blocks"]
                         for i in render_compare.block_views(len(want))}}
    res = render_compare.compare(
        record, [render_compare.summarize(r, a) for r, a in got])
    assert res["ok"] and max(res["max_diff"].values()) <= TOL_PIXEL, res
    for p in sorted((runs["root"] / "port").glob("view_*.png")):
        mine = np.asarray(Image.open(p)).astype(int)
        theirs = np.asarray(Image.open(runs["root"] / "jax" / p.name))
        assert np.abs(mine[:, :W] - theirs[:, :W, :3]).max() <= 1, p.name


def test_path_view_through_the_tiled_rasterizer_matches_jax():
    """The middle view of the path (between two keyframes) of the same
    scene (the JAX package's, carried across) through
    rasterize(backend="pallas") in both packages: the port's plain tile
    walk against the Pallas kernel in interpret mode, within
    TOL_PIXEL."""
    from gsplatloc_tpu.data.datasets import get_dataset
    from gsplatloc_tpu.models.gaussians import scene_from_point_cloud
    from gsplatloc_tpu.ops import camera
    from gsplatloc_tpu.ops.lie import invert_se3, transform_points
    from gsplatloc_tpu.ops.rasterize import rasterize as j_rasterize
    from gsplatloc_tpu_torch.ops.lie import invert_se3 as t_invert
    from gsplatloc_tpu_torch.ops.rasterize import rasterize

    ds = get_dataset("Synthetic", "", n_frames=12, height=H, width=W)
    frame = ds[0]
    K = jnp.asarray(frame.K, jnp.float32)
    pts = transform_points(jnp.asarray(frame.c2w, jnp.float32),
                           camera.depth_to_points(
                               jnp.asarray(frame.depth, jnp.float32), K))
    scene_j = scene_from_point_cloud(
        pts, jnp.asarray(frame.rgb.reshape(-1, 3), jnp.float32) / 255.0,
        grid_shape=(H, W))
    scene_t = scene_from_numpy(
        {k: np.asarray(getattr(scene_j, k)) for k in scene_j._fields},
        device="cpu")
    poses = np.stack([np.asarray(ds[i].c2w) for i in range(12)])
    path = ttraj.generate_interpolated_path(poses, 2, look_at_neighbor=False)
    c2w = path[len(path) // 2].astype(np.float32)
    r_j, a_j = j_rasterize(
        scene_j.means, scene_j.quats, scene_j.scales, scene_j.opacities,
        scene_j.sh_coeffs, invert_se3(jnp.asarray(c2w)), K, W, H,
        sh_degree=1, render_mode="RGB+ED", backend="pallas")
    with torch.no_grad():
        r_t, a_t = rasterize(
            scene_t.means, scene_t.quats, scene_t.scales, scene_t.opacities,
            scene_t.sh_coeffs, t_invert(torch.as_tensor(c2w)),
            torch.as_tensor(np.array(K)), W, H, sh_degree=1,
            render_mode="RGB+ED", backend="pallas")
    r_t, a_t, r_j, a_j = to_np(r_t), to_np(a_t), np.asarray(r_j), \
        np.asarray(a_j)
    assert float(a_j.mean()) > 0.5  # the view sees the room
    assert np.abs(r_t[..., :3] - r_j[..., :3]).max() <= TOL_PIXEL
    assert np.abs(a_t - a_j).max() <= TOL_PIXEL
    ed = np.abs(r_t[..., 3] - r_j[..., 3]) / np.maximum(np.abs(r_j[..., 3]),
                                                         1e-30)
    assert ed.max() <= TOL_PIXEL


def test_cli_render_records_its_timers(tmp_path):
    from gsplatloc_tpu_torch.utils import profiling

    profiling.reset_timers()
    cli.main(["render", "--device", "cpu", "--height", "16", "--width",
              "24", "--n-views", "2", "--out", str(tmp_path)])
    n = len(list(tmp_path.glob("view_*.png")))
    assert n == 11
    for name, count in (("render/data", 1), ("render/scene", 1),
                        ("render/view", n), ("render/panel", n)):
        assert profiling.timer_stats(name)["count"] == count, name
    profiling.reset_timers()


def test_render_reference_record_is_whole():
    """The committed record of the JAX package's run at its defaults."""
    rec = render_compare.load_reference()
    assert rec["views"] == len(rec["per_view"]) == 22
    assert (rec["height"], rec["width"]) == (240, 320)
    assert sorted(rec["blocks"], key=int) == ["0", "11", "21"]
    assert np.shape(rec["blocks"]["11"]["r"]) == (15, 20)
    assert "cpu" in rec["machine"].lower() and rec["jax"] and rec["numpy"]
    assert render_compare.REFERENCE.stat().st_size < 200_000


@pytest.mark.parametrize("where", ["mean", "block"])
@pytest.mark.parametrize("ch", ["r", "alpha", "ed"])
def test_render_compare_fails_on_nan(ch, where):
    """A NaN in a view's mean or in one block mean fails the gate, with an
    infinite distance for its channel; the same summaries without it
    pass."""
    rng = np.random.default_rng(7)
    views = []
    for _ in range(3):
        render = rng.uniform(0.1, 1.0, (32, 32, 4))
        views.append(render_compare.summarize(render, render[..., 0]))
    record = {"views": 3,
              "per_view": [{k: v for k, v in s.items() if k != "blocks"}
                           for s in views],
              "blocks": {str(i): views[i]["blocks"]
                         for i in render_compare.block_views(3)}}
    assert render_compare.compare(record, views)["ok"]
    bad = [dict(s, blocks={k: [list(r) for r in v]
                           for k, v in s["blocks"].items()}) for s in views]
    if where == "mean":
        bad[1][ch] = float("nan")
    else:
        bad[1]["blocks"][ch][1][0] = float("nan")
    res = render_compare.compare(record, bad)
    assert not res["ok"] and res["max_diff"][ch] == float("inf"), res


# ------------------------------------------------------------ viewer
def test_viewer_serves_page_png_stats_and_pause():
    """The port's viewer (backend "pallas": the tiled rasterizer's plain
    walk on the CPU) serves the page, a PNG frame equal to a direct render
    of its camera, its stats and the pause toggle."""
    from gsplatloc_tpu_torch.data.synthetic import random_gaussian_cloud
    from gsplatloc_tpu_torch.eval.viewer import LiveViewer
    from gsplatloc_tpu_torch.models.gaussians import scene_from_point_cloud
    from gsplatloc_tpu_torch.ops.camera import intrinsics_matrix

    rng = np.random.default_rng(0)
    pts, rgb = random_gaussian_cloud(rng, 200)
    scene = scene_from_point_cloud(pts, rgb, device="cpu")
    scene = scene._replace(scales=torch.full_like(scene.scales, 0.08))
    K = intrinsics_matrix(60.0, 60.0, 39.5, 23.5)
    port = 18761
    base = f"http://127.0.0.1:{port}"
    viewer = LiveViewer(K, width=80, height=48, port=port, backend="pallas",
                        device="cpu").start()
    try:
        black = urllib.request.urlopen(base + "/render", timeout=60).read()
        assert not png.decode(black).any()  # no scene yet
        viewer.set_scene(scene)
        viewer.update(step=5, rays_per_sec=1e6)
        page = urllib.request.urlopen(base + "/", timeout=30).read()
        assert b"gsplatloc_tpu" in page and b"<img" in page
        query = "tx=0&ty=0&tz=-1&rx=0&ry=0"
        resp = urllib.request.urlopen(f"{base}/render?{query}", timeout=120)
        assert resp.headers["Content-Type"] == "image/png"
        frame = resp.read()
        assert frame.startswith(png.SIGNATURE) and len(frame) > 500
        rgb_img = png.decode(frame)[..., ::-1]
        direct = viewer.render_rgb({k: [v] for k, v in (
            kv.split("=") for kv in query.split("&"))})
        np.testing.assert_array_equal(rgb_img, direct)
        assert rgb_img.shape == (48, 80, 3) and rgb_img.max() > 0
        stats = json.loads(urllib.request.urlopen(base + "/stats",
                                                  timeout=30).read())
        assert stats == {"step": 5, "rays_per_sec": 1e6, "paused": False}
        urllib.request.urlopen(base + "/toggle_pause", timeout=30).read()
        assert viewer.paused
        urllib.request.urlopen(base + "/toggle_pause", timeout=30).read()
        assert not viewer.paused
    finally:
        viewer.stop()
