"""Lens undistortion and bilinear remapping of 8-bit images, numpy only.

The TUM loader undistorts colour as `cv2.undistort(bgr, K, dist)` does, and
the TUM fixture writer resamples colour through the distortion model as
`cv2.remap(rgb, mapx, mapy, INTER_LINEAR, BORDER_REPLICATE)` with float32
maps does; neither needs OpenCV here.

`undistort` follows OpenCV's fixed-point 8-bit remap (`remap_fixed`):

  * a source coordinate is rounded to 1/32 pixel (`INTER_BITS` 5): the
    integer pixel and a 5-bit fraction in each axis;
  * the four corner weights come from a 32x32 table of 15-bit fixed-point
    products (`INTER_REMAP_COEF_BITS`), adjusted to sum to exactly 2^15;
  * the weighted sum is rounded with +2^14 and shifted down by 15;
  * a corner outside the image reads 0 (constant border).

`undistort_maps` builds the inverse map of `initUndistortRectifyMap(K, dist,
None, K)`: for every output pixel, the distorted source pixel (float64).

`remap_linear` is the float form OpenCV 5 takes for float32 maps: float32
weights, each row blended first, then the two rows, rounded half to even.
"""

from __future__ import annotations

import numpy as np

INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS
COEF_BITS = 15
COEF_SCALE = 1 << COEF_BITS


def _weight_table() -> np.ndarray:
    """(32, 32, 4) int32 corner weights (00, 01, 10, 11) for each (y, x)
    fraction, summing to COEF_SCALE."""
    frac = np.arange(INTER_TAB_SIZE, dtype=np.float32) / np.float32(
        INTER_TAB_SIZE)
    lin = np.stack([np.float32(1.0) - frac, frac], axis=-1)  # (32, 2)
    tab = np.empty((INTER_TAB_SIZE, INTER_TAB_SIZE, 4), np.int32)
    for i in range(INTER_TAB_SIZE):
        for j in range(INTER_TAB_SIZE):
            w = (lin[i][:, None] * lin[j][None, :]).astype(np.float32)
            iw = np.rint(w.astype(np.float64) * COEF_SCALE).astype(np.int64)
            diff = int(iw.sum()) - COEF_SCALE
            if diff:
                flat = iw.ravel()
                # the largest weight takes a deficit, the smallest a surplus
                # (first in row-major order on ties)
                if diff < 0:
                    flat[int(np.argmax(flat))] -= diff
                else:
                    flat[int(np.argmin(flat))] -= diff
            tab[i, j] = iw.ravel()
    return tab


_TAB = None


def _table() -> np.ndarray:
    global _TAB
    if _TAB is None:
        _TAB = _weight_table()
    return _TAB


def remap_fixed(img: np.ndarray, iu: np.ndarray, iv: np.ndarray
                ) -> np.ndarray:
    """Bilinear remap of a uint8 (H, W) or (H, W, C) image at source
    coordinates given in 1/32 pixel (int arrays iu = round(u * 32), iv =
    round(v * 32), of the output's shape), constant zero border."""
    if img.dtype != np.uint8:
        raise ValueError(f"remap_fixed takes uint8 images, not {img.dtype}")
    src = img if img.ndim == 3 else img[..., None]
    h, w = src.shape[:2]
    x0 = iu >> INTER_BITS
    y0 = iv >> INTER_BITS
    wts = _table()[iv & (INTER_TAB_SIZE - 1), iu & (INTER_TAB_SIZE - 1)]
    acc = np.zeros(iu.shape + (src.shape[2],), np.int64)
    for k, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        y, x = y0 + dy, x0 + dx
        inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        pix = src[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)]
        pix = np.where(inside[..., None], pix, 0)
        acc += pix.astype(np.int64) * wts[..., k:k + 1]
    out = np.clip((acc + (1 << (COEF_BITS - 1))) >> COEF_BITS, 0, 255)
    out = out.astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]


def undistort_maps(K: np.ndarray, dist, h: int, w: int):
    """(u, v) float64 (h, w): the distorted source pixel of each output
    pixel for the camera K (3, 3) and the coefficients dist (k1, k2, p1,
    p2[, k3[, k4, k5, k6]]), with the output camera K itself. The
    normalized coordinates run along each row by repeated addition, in
    the order `initUndistortRectifyMap` forms them."""
    d = np.zeros(8)
    dist = np.asarray(dist, np.float64).ravel()
    d[:dist.size] = dist
    k1, k2, p1, p2, k3, k4, k5, k6 = d
    A = np.asarray(K, np.float64)
    fx, fy, u0, v0 = A[0, 0], A[1, 1], A[0, 2], A[1, 2]
    ir = np.linalg.inv(A).ravel()
    rows = np.arange(h, dtype=np.float64)
    x = np.empty((h, w))
    y = np.empty((h, w))
    wgt = np.empty((h, w))
    _x, _y, _w = rows * ir[1] + ir[2], rows * ir[4] + ir[5], rows * ir[7] + ir[8]
    for j in range(w):
        x[:, j], y[:, j], wgt[:, j] = _x, _y, _w
        _x, _y, _w = _x + ir[0], _y + ir[3], _w + ir[6]
    iw = 1.0 / wgt
    x, y = x * iw, y * iw
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1 + ((k6 * r2 + k5) * r2
                                                      + k4) * r2)
    u = fx * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)) + u0
    v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy) + v0
    return u, v


def undistort(img: np.ndarray, K: np.ndarray, dist) -> np.ndarray:
    """The uint8 image `img` undistorted with camera K and coefficients
    dist, output camera K, constant zero border (`cv2.undistort`)."""
    h, w = img.shape[:2]
    u, v = undistort_maps(K, dist, h, w)
    # to 1/32 pixel, rounded half to even
    return remap_fixed(img, np.rint(u * INTER_TAB_SIZE).astype(np.int64),
                       np.rint(v * INTER_TAB_SIZE).astype(np.int64))


def remap_linear(img: np.ndarray, mapx: np.ndarray, mapy: np.ndarray
                 ) -> np.ndarray:
    """Bilinear remap of a uint8 (H, W) or (H, W, C) image at the float32
    source coordinates (mapx, mapy), replicated border, in float32."""
    if img.dtype != np.uint8:
        raise ValueError(f"remap_linear takes uint8 images, not {img.dtype}")
    src = img if img.ndim == 3 else img[..., None]
    h, w = src.shape[:2]
    mapx = np.asarray(mapx, np.float32)
    mapy = np.asarray(mapy, np.float32)
    x0f, y0f = np.floor(mapx), np.floor(mapy)
    ax = (mapx - x0f)[..., None]
    ay = (mapy - y0f)[..., None]
    x0, y0 = x0f.astype(np.int64), y0f.astype(np.int64)

    def at(y, x):
        return src[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)].astype(
            np.float32)

    one = np.float32(1.0)
    top = at(y0, x0) * (one - ax) + at(y0, x0 + 1) * ax
    bot = at(y0 + 1, x0) * (one - ax) + at(y0 + 1, x0 + 1) * ax
    val = top * (one - ay) + bot * ay
    out = np.clip(np.rint(val), 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]
