"""The port's TUM path without OpenCV: the stdlib PNG reader and writer,
the numpy undistortion, the TUM fixture writer against
`scripts/make_tum_fixture.py`, and the port's `TUM` loader against the
reference's, on the same files.

The script runs as a subprocess into `tmp_path` at 80x64 with 6 frames.
Tolerances: the text files, `cam_params.json` and the decoded depth are
equal byte for byte / bit for bit; the colour equals OpenCV's decode and
undistortion with OpenCV 5, held to at most 1 grey level
(OpenCV's 8-bit remap may differ in the last level between versions); the
loader's depth, K and poses equal the reference loader's bit for bit."""

import filecmp
import json
import os
import pathlib
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from gsplatloc_tpu.data.datasets import TUM as JTUM
from gsplatloc_tpu_torch import cli
from gsplatloc_tpu_torch.data import png, tum_fixture, undistort
from gsplatloc_tpu_torch.data.datasets import TUM
from gsplatloc_tpu_torch.data.parser import Parser
from gsplatloc_tpu_torch.eval import fixture_compare
from gsplatloc_tpu_torch.models.gaussians import scene_from_point_cloud
from gsplatloc_tpu_torch.opt.tracking import TrackingConfig, optimize_pose
from torch_port_helpers import to_np  # noqa: F401  (pins torch's threads)

ROOT = pathlib.Path(__file__).resolve().parent.parent
H, W, N_FRAMES = 64, 80, 6
SCENES = {"freiburg1_desk": [], "freiburg2_stress": ["--stress"]}


def _filtered(rows: np.ndarray, ftype: int, bpp: int) -> np.ndarray:
    """PNG filter `ftype` applied to every row of (H, n) raw bytes; returns
    (H, 1 + n) with the filter byte first."""
    x = rows.astype(np.int32)
    out = np.zeros((x.shape[0], x.shape[1] + 1), np.uint8)
    for r in range(x.shape[0]):
        prior = x[r - 1] if r else np.zeros_like(x[r])
        a = np.concatenate([np.zeros(bpp, np.int32), x[r, :-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        b = prior
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = [np.zeros_like(a), a, b, (a + b) >> 1, paeth][ftype]
        out[r, 0] = ftype
        out[r, 1:] = (x[r] - pred) & 255
    return out


def _write_filtered(path, img: np.ndarray, ftype: int):
    """An RGB (given as RGB), grey, RGBA or 16-bit grey PNG with filter
    `ftype` on every row (-1: each row its own, cycling 0-4)."""
    if img.dtype == np.uint16:
        rows, bpp, depth, ctype = img.astype(">u2").view(np.uint8), 2, 16, 0
    else:
        ch = 1 if img.ndim == 2 else img.shape[2]
        rows, bpp, depth, ctype = img, ch, 8, {1: 0, 3: 2, 4: 6}[ch]
    rows = rows.reshape(img.shape[0], -1)
    if ftype >= 0:
        raw = _filtered(rows, ftype, bpp)
    else:
        raw = np.stack([_filtered(rows, r % 5, bpp)[r]
                        for r in range(rows.shape[0])])

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    pathlib.Path(path).write_bytes(
        png.SIGNATURE
        + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], img.shape[0],
                                     depth, ctype, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw.tobytes()))
        + chunk(b"IEND", b""))


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    bgr = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    d16 = rng.integers(0, 65536, (17, 23), dtype=np.uint16)
    png.imwrite(tmp_path / "c.png", bgr)
    png.imwrite(tmp_path / "d.png", d16)
    got_c, got_d = png.imread(tmp_path / "c.png"), png.imread(tmp_path / "d.png")
    assert got_c.dtype == np.uint8 and np.array_equal(got_c, bgr)
    assert got_d.dtype == np.uint16 and np.array_equal(got_d, d16)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, -1])
@pytest.mark.parametrize("kind", ["rgb8", "grey16"])
def test_png_reader_agrees_with_opencv(tmp_path, kind, ftype):
    """Every filter type (and all five mixed row by row), decoded as
    cv2.imread(IMREAD_UNCHANGED) decodes it: 8-bit RGB as BGR, 16-bit
    grey with its big-endian samples."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(ftype + 5)
    img = (rng.integers(0, 256, (19, 29, 3), dtype=np.uint8) if kind == "rgb8"
           else rng.integers(0, 65536, (19, 29), dtype=np.uint16))
    path = tmp_path / "f.png"
    _write_filtered(path, img, ftype)
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    got = png.imread(path)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if kind == "rgb8":
        assert np.array_equal(got, img[..., ::-1])


@pytest.mark.parametrize("channels", [1, 4])
def test_png_reader_grey8_and_rgba8(tmp_path, channels):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(channels)
    shape = (13, 31) if channels == 1 else (13, 31, 4)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    _write_filtered(tmp_path / "g.png", img, -1)
    want = cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_UNCHANGED)
    assert np.array_equal(png.imread(tmp_path / "g.png"), want)


def test_png_reader_reads_opencvs_own_files(tmp_path):
    """Files written by OpenCV (its own filter choice per row)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    bgr = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    bgr[:, :32] = 77  # flat areas, where other filters win
    d16 = (rng.random((48, 64)) * 30000).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "c.png"), bgr)
    cv2.imwrite(str(tmp_path / "d.png"), d16)
    assert np.array_equal(png.imread(tmp_path / "c.png"), bgr)
    assert np.array_equal(png.imread(tmp_path / "d.png"), d16)


@pytest.mark.parametrize("what", ["interlaced", "palette", "not_png"])
def test_png_reader_refuses_what_it_cannot_read(tmp_path, what):
    path = tmp_path / "x.png"
    _write_filtered(path, np.zeros((4, 4, 3), np.uint8), 0)
    data = bytearray(path.read_bytes())
    if what == "not_png":
        data[1] = ord("X")
    else:
        # IHDR body starts at byte 16: w, h, depth, ctype, comp, filt, lace
        data[16 + 9 if what == "palette" else 16 + 12] = \
            3 if what == "palette" else 1
        crc = zlib.crc32(bytes(data[12:16 + 13]))
        data[29:33] = struct.pack(">I", crc)
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="interlaced|palette|not a PNG"):
        png.imread(path)


def test_undistort_equals_opencv():
    """undistort against cv2.undistort on noise at the fixture's camera:
    equal with OpenCV 5; held to 1 grey level."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    h, w = 120, 160
    K = np.array([[130.0, 0, w / 2 - 0.5], [0, 130.0, h / 2 - 0.5],
                  [0, 0, 1]], np.float32)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    got = undistort.undistort(img, K, np.array(tum_fixture.DIST))
    want = cv2.undistort(img, K, np.array(tum_fixture.DIST))
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1, d.max()


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Both scenes written by the script and by the port."""
    out = tmp_path_factory.mktemp("tum_fixture")
    for scene, extra in SCENES.items():
        subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "make_tum_fixture.py"),
             "--frames", str(N_FRAMES), "--height", str(H), "--width",
             str(W), "--scene", scene, "--out", str(out / "script"), *extra],
            check=True, capture_output=True, cwd=str(ROOT), timeout=600,
            env=dict(os.environ, PYTHONPATH=str(ROOT)))
        tum_fixture.write_tum_fixture(
            out / "port", frames=N_FRAMES, height=H, width=W, scene=scene,
            stress=bool(extra), workers=2)
    return out


@pytest.mark.parametrize("scene", list(SCENES))
def test_writer_equals_the_script(written, scene):
    cv2 = pytest.importorskip("cv2")
    a = written / "script" / f"rgbd_dataset_{scene}"
    b = written / "port" / f"rgbd_dataset_{scene}"
    for name in ("rgb.txt", "depth.txt", "groundtruth.txt",
                 "cam_params.json"):
        assert filecmp.cmp(a / name, b / name, shallow=False), name
    for sub in ("rgb", "depth"):
        assert sorted(p.name for p in (a / sub).iterdir()) == sorted(
            p.name for p in (b / sub).iterdir())
    for p in (a / "depth").iterdir():
        want = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
        assert np.array_equal(png.imread(b / "depth" / p.name), want)
    worst = 0
    for p in (a / "rgb").iterdir():
        want = cv2.imread(str(p), cv2.IMREAD_UNCHANGED).astype(int)
        worst = max(worst, np.abs(png.imread(b / "rgb" / p.name)
                                  - want).max())
    assert worst <= 1, worst


@pytest.mark.parametrize("scene", list(SCENES))
def test_loader_equals_the_reference_loader(written, scene):
    """The port's TUM loader (no OpenCV) against the reference's (OpenCV)
    on the script's files: depth, K and poses bit for bit, colour within
    1 grey level."""
    root = written / "script"
    ref, port = JTUM(scene, root=root), TUM(scene, root=root)
    assert len(ref) == len(port) >= 3
    assert np.array_equal(ref.K, port.K) and np.array_equal(ref.K_raw,
                                                            port.K_raw)
    for i in range(len(ref)):
        fr, fp = ref[i], port[i]
        assert fp.depth.dtype == fr.depth.dtype
        assert np.array_equal(fp.depth, fr.depth)
        assert np.array_equal(fp.c2w, fr.c2w) and fp.c2w.dtype == fr.c2w.dtype
        assert np.array_equal(fp.K, fr.K)
        assert fp.rgb.shape == fr.rgb.shape == (H - 16, W - 16, 3)
        assert np.abs(fp.rgb - fr.rgb).max() <= 1


def test_loader_reads_without_opencv(written, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises
    ds = TUM("freiburg1_desk", root=written / "port")
    assert ds[1].depth.shape == (H - 16, W - 16)


def test_colour_does_not_reach_the_pose(written):
    """A short CPU track of pair 0 with the loader's colours and one with
    the colours inverted give the same best pose bit for bit: colour
    reaches only the SH DC term, the loss is depth-only."""
    p = Parser("TUM", "freiburg1_desk", backend="subtile", knn_method="grid",
               device="cpu", root=written / "port")
    h, w = H - 16, W - 16
    data = p[0]
    out = []
    for colors in (data.colors, 255.0 - data.colors):
        scene = scene_from_point_cloud(data.tar_points, colors,
                                       grid_shape=(h, w), device="cpu")
        res = optimize_pose(scene, data.tar_c2w, data.src_depth, p.K, w, h,
                            config=TrackingConfig(max_steps=30,
                                                  warmup_steps=10),
                            device="cpu")
        out.append((scene, res))
    (s0, r0), (s1, r1) = out
    assert not torch.equal(s0.sh_coeffs, s1.sh_coeffs)
    assert torch.equal(r0.best_pose.quat, r1.best_pose.quat)
    assert torch.equal(r0.best_pose.trans, r1.best_pose.trans)
    assert torch.equal(r0.best_loss, r1.best_loss)


def test_suite_association_gives_the_reference_pairs(tmp_path):
    """desk at its suite arguments associates 34 frames: the reference's
    33 pairs (the clocks do not depend on the image size)."""
    root = tum_fixture.write_tum_fixture(
        tmp_path, height=24, width=32, scene="freiburg1_desk", workers=2,
        **tum_fixture.SUITE["freiburg1_desk"])
    ref = fixture_compare.load_reference()["tum"]["freiburg1_desk"]
    assert len(TUM("freiburg1_desk", root=tmp_path)) == ref["frames"] == 34
    assert root == tmp_path / "rgbd_dataset_freiburg1_desk"


def test_cli_track_on_a_tum_scene(written, tmp_path):
    cli.main(["track", "--device", "cpu", "--dataset", "TUM", "--data-root",
              str(written / "port"), "--rooms", "freiburg2_stress",
              "--num-iters", "20", "--max-pairs", "2", "--knn", "exact",
              "--run-dir", str(tmp_path), "--quiet"])
    res = json.loads((tmp_path / "res.json").read_text())
    assert "freiburg2_stress" in res["TUM"]
    pairs = fixture_compare.run_pairs(tmp_path / "freiburg2_stress")
    assert len(pairs) == 2 and np.isfinite([p["eT"] for p in pairs]).all()
    cfg = json.loads((tmp_path / "freiburg2_stress" / "config.json")
                     .read_text())
    assert cfg["dataset"] == "TUM" and cfg["knn_method"] == "exact"


@pytest.mark.parametrize("scene", list(SCENES))
def test_compare_holds_the_tum_records_against_themselves(scene):
    ref = fixture_compare.load_reference()["tum"][scene]
    c = fixture_compare.compare(ROOT / ref["source"], scene, range(0, 5))
    assert c["ate_ratio"] == 1.0 and c["clamped_equal"]
    assert c["port"]["ate_rmse"] == c["reference"]["ate_rmse"] > 0


def test_compare_class_holds_a_run_to_the_whole_reference():
    """The stress scene's run is other frames than the reference's: it is
    held to the reference's whole-run RMSEs only."""
    ref = fixture_compare.load_reference()["tum"]["freiburg2_stress"]
    c = fixture_compare.compare_class(ROOT / ref["source"], "freiburg2_stress")
    assert c["ate_ratio"] == c["aae_ratio"] == 1.0
    assert c["clamped_equal"] is None and len(c["pairs"]) == 27
    assert "freiburg2_stress" not in tum_fixture.PER_PAIR
    assert "freiburg1_desk" in tum_fixture.PER_PAIR
