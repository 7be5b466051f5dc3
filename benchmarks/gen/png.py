"""16-bit grey and 8-bit BGR PNG writing with the standard library (frozen
copy of `gsplatloc_tpu_torch/data/png.py:encode`): filter 0 on every row,
zlib's default level."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode(img: np.ndarray) -> bytes:
    """uint8 BGR (H, W, 3) as 8-bit RGB, or uint16 (H, W) as 16-bit grey."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, ctype = 8, 2
        pix = img[..., ::-1]
    elif img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype = 16, 0
        pix = img.astype(">u2")
    else:
        raise ValueError(f"png.encode takes uint8 (H, W, 3) or uint16 "
                         f"(H, W), not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(pix).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                          0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def imwrite(path, img: np.ndarray) -> None:
    Path(path).write_bytes(encode(img))
