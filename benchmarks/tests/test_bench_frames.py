"""The frozen writers' frames, read back through the port's loaders, are
the port's own fixture frames; a clip folder reads the same through the
port's loader and through the reference's."""

import numpy as np
import pytest

import harness

TINY = dict(height=68, width=120, frames=5)


def tiny(name: str, **kw) -> dict:
    cfg = harness.config(name)
    cfg.update(kw)
    return cfg


@pytest.fixture
def replica_cache(tmp_path):
    cfg = tiny("replica-room0", fx=60.0, fy=60.0, **TINY)
    harness.adapter(cfg).write_cache(tmp_path / "r", cfg)
    return tmp_path / "r", cfg


@pytest.fixture
def tum_cache(tmp_path):
    from gen.tum import DIST

    # the fixture's camera: centred principal point, its distortion
    cfg = tiny("tum-fr1-desk", height=96, width=128, fx=104.0, fy=104.0,
               cx=63.5, cy=47.5, distortion=DIST, frames=6)
    harness.adapter(cfg).write_cache(tmp_path / "t", cfg)
    return tmp_path / "t", cfg


def test_replica_frames_are_the_fixture_frames(replica_cache):
    from gsplatloc_tpu_torch.data.datasets import Replica
    from gsplatloc_tpu_torch.data.fixtures import ReplicaFixture

    root, cfg = replica_cache
    files = Replica("room0", root=root)
    fixture = ReplicaFixture("room0", frames=TINY["frames"],
                             height=TINY["height"], width=TINY["width"],
                             workers=2)
    try:
        assert len(files) == len(fixture) == TINY["frames"]
        np.testing.assert_array_equal(files.K, fixture.K)
        for i in range(len(files)):
            a, b = files[i], fixture[i]
            np.testing.assert_array_equal(a.depth, b.depth)
            np.testing.assert_array_equal(a.c2w, b.c2w)
    finally:
        fixture.close()


def test_tum_frames_are_the_fixture_frames(tum_cache, tmp_path):
    from gsplatloc_tpu_torch.data.datasets import TUM
    from gsplatloc_tpu_torch.data.tum_fixture import write_tum_fixture

    root, cfg = tum_cache
    write_tum_fixture(tmp_path / "port", frames=6, height=96, width=128,
                      workers=2)
    a = TUM("freiburg1_desk", root=root)
    b = TUM("freiburg1_desk", root=tmp_path / "port")
    assert len(a) == len(b) > 2
    np.testing.assert_array_equal(a.K, b.K)
    for i in range(len(a)):
        np.testing.assert_array_equal(a[i].depth, b[i].depth)
        np.testing.assert_array_equal(a[i].rgb, b[i].rgb)
        np.testing.assert_array_equal(a[i].c2w, b[i].c2w)


@pytest.mark.parametrize("layout", ["replica", "tum"])
def test_clip_reads_alike(layout, replica_cache, tum_cache, tmp_path):
    from gsplatloc_tpu_torch.data.datasets import get_dataset

    root, cfg = replica_cache if layout == "replica" else tum_cache
    mod = harness.adapter(cfg)
    frames = [1, 2, 4]
    kw = mod.make_clip(root, cfg, frames, tmp_path / "clip")
    port = get_dataset(kw.pop("data_set"), kw.pop("scene_name"), **kw)
    K, ref = mod.read_clip(tmp_path / "clip", cfg)
    assert len(port) == len(ref) == len(frames)
    np.testing.assert_array_equal(K, port.K)
    for i, (depth, c2w) in enumerate(ref):
        np.testing.assert_array_equal(depth, port[i].depth)
        np.testing.assert_array_equal(c2w, port[i].c2w)


def test_tum_distortion_inverts_the_ports_undistortion():
    """At fr1/desk's calibration (all five coefficients, off-centre
    principal point), the writer's map takes the distorted pixel that the
    port's undistortion reads for a pinhole pixel back to that pixel."""
    from gen.tum import distort_maps
    from gsplatloc_tpu_torch.data.undistort import undistort_maps

    cfg = harness.config("tum-fr1-desk")
    h, w = cfg["height"], cfg["width"]
    K = np.array([[cfg["fx"], 0, cfg["cx"]], [0, cfg["fy"], cfg["cy"]],
                  [0, 0, 1]])
    mapx, mapy = distort_maps(K.astype(np.float32), h, w,
                              cfg["distortion"])
    u, v = undistort_maps(K, cfg["distortion"], h, w)
    inside = (u > 1) & (u < w - 2) & (v > 1) & (v < h - 2)
    assert inside.mean() > 0.8
    u, v = u[inside], v[inside]
    i0, j0 = np.floor(v).astype(int), np.floor(u).astype(int)
    a, b = u - j0, v - i0

    def at(m):
        return ((1 - b) * ((1 - a) * m[i0, j0] + a * m[i0, j0 + 1])
                + b * ((1 - a) * m[i0 + 1, j0] + a * m[i0 + 1, j0 + 1]))

    px, py = np.meshgrid(np.arange(w), np.arange(h))
    err = np.hypot(at(mapx) - px[inside], at(mapy) - py[inside])
    assert err.max() < 0.02, err.max()
