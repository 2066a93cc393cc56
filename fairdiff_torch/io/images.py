"""Image output ([-1, 1] float HWC -> 8-bit RGB PNG), written with the
standard library's zlib and struct only."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def to_uint8(images: np.ndarray) -> np.ndarray:
    """[-1,1] float -> uint8 [0,255]."""
    return (
        (np.clip(np.asarray(images, np.float32), -1, 1) * 0.5 + 0.5) * 255.0
    ).round().astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def save_png(img: np.ndarray, path: str | Path) -> None:
    """Write one [H, W, 3] image in [-1, 1] as an 8-bit RGB PNG."""
    pixels = to_uint8(img)
    if pixels.ndim != 3 or pixels.shape[-1] != 3:
        raise ValueError(f"want an [H, W, 3] image, got {pixels.shape}")
    h, w, _ = pixels.shape
    # filter type 0 (none) in front of every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, w * 3)], axis=1)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(png)
