"""PNG reading and writing with the standard library and numpy.

`imread(path)` returns what `cv2.imread(path, cv2.IMREAD_UNCHANGED)` returns
for the images this package meets, pixel for pixel: 8-bit grey (H, W),
8-bit RGB as BGR (H, W, 3), 8-bit RGBA as BGRA (H, W, 4), all uint8, and
16-bit grey (H, W) uint16. It reads every filter type (0-4) of a
non-interlaced image and raises on anything else: Adam7 interlacing,
palette images, other bit depths, 16-bit colour.

`imwrite(path, img)` writes an 8-bit BGR image (H, W, 3) as RGB, or a
uint16 (H, W) image as 16-bit grey, with filter 0 on every row;
`encode(img)` and `decode(data)` do the same in memory.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for the types read here
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes, path):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in a {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG (no IEND)")


def _unfilter(raw: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters of (H, W, bpp) filtered bytes. A byte
    depends on its left, upper and upper-left neighbours, so the image is
    decoded one anti-diagonal of pixels at a time, every row of the
    diagonal at once, each with its own filter."""
    h, w, _ = raw.shape
    if not ftype.any():
        return raw.astype(np.uint8)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row and column
    raw = raw.astype(np.int32)
    ft = ftype.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        c = d - r
        x = raw[r, c]
        a = out[r + 1, c]      # left
        b = out[r, c + 1]      # up
        ul = out[r, c]         # upper left
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, ul))
        f = ft[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, c + 1] = (x + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def imread(path) -> np.ndarray:
    """Decode a PNG file as `cv2.imread(path, IMREAD_UNCHANGED)` does."""
    return decode(Path(path).read_bytes(), path)


def decode(data: bytes, path="<bytes>") -> np.ndarray:
    """`imread` of a PNG file held in memory (path names it in errors)."""
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if interlace != 0:
        raise ValueError(f"{path}: Adam7 interlaced PNGs are not read")
    if ctype == 3:
        raise ValueError(f"{path}: palette PNGs are not read")
    if ctype not in _CHANNELS or comp != 0 or filt != 0:
        raise ValueError(f"{path}: colour type {ctype} is not read")
    if depth not in (8, 16) or (depth == 16 and ctype != 0):
        raise ValueError(f"{path}: bit depth {depth} with colour type "
                         f"{ctype} is not read")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if flat.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {flat.size} bytes of image data, "
                         f"expected {h * (1 + w * bpp)}")
    rows = flat.reshape(h, 1 + w * bpp)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"{path}: unknown filter type {ftype.max()}")
    pix = _unfilter(rows[:, 1:].reshape(h, w, bpp), ftype, bpp)
    if depth == 16:
        return pix.view(">u2")[..., 0].astype(np.uint16)
    if ch == 1:
        return pix[..., 0]
    # RGB(A) -> BGR(A), OpenCV's channel order
    return np.ascontiguousarray(pix[..., [2, 1, 0, 3][:ch]])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode(img: np.ndarray) -> bytes:
    """The PNG file `imwrite` writes for `img`, as bytes."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, ctype = 8, 2
        pix = img[..., ::-1]
    elif img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype = 16, 0
        pix = img.astype(">u2")
    else:
        raise ValueError(f"imwrite takes uint8 (H, W, 3) or uint16 (H, W), "
                         f"not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(pix).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                          0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def imwrite(path, img: np.ndarray) -> None:
    """Write a uint8 BGR (H, W, 3) image as 8-bit RGB or a uint16 (H, W)
    image as 16-bit grey (big-endian samples), filter 0 on every row."""
    Path(path).write_bytes(encode(img))
