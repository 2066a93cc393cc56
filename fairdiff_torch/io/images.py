"""Image files ([-1, 1] float HWC <-> 8-bit PNG), written and read with the
standard library's zlib and struct and numpy only (the card's machine has no
PIL). `load_image` reads what the JAX package's does (PIL's
`.convert("RGB")`): PNG with the port's own decoder, JPEG through PIL where
PIL imports."""

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
    write_png(to_uint8(img), path)


def write_png(pixels: np.ndarray, path: str | Path) -> None:
    """Write [H, W, 3] uint8 pixels as an RGB PNG."""
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


_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels a pixel by colour type: grey, RGB, palette, grey + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(raw: bytes, height: int, width: int, bpp: int, name: str) -> np.ndarray:
    """Undo the five scanline filters (None, Sub, Up, Average, Paeth) of an
    8-bit non-interlaced image -> [height, width * bpp] uint8."""
    stride = width * bpp
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{name}: {len(raw)} bytes of image data, want {height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along each channel, mod 256
            cur = np.cumsum(line.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(stride)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs the one reconstructed before it
            cur = bytearray(line.tobytes())
            up = prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    cur[i] = (cur[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{name}: scanline {y} has filter type {kind}")
        out[y] = prev = cur
    return out


def decode_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """8-bit PNG bytes -> [H, W, 3] uint8 RGB as PIL's `.convert("RGB")`
    gives it: grey replicated, a palette looked up, alpha dropped. Another
    bit depth, interlacing or a bad CRC raises ValueError naming `name`."""
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    pos, header, palette, idat = len(_SIGNATURE), None, None, []
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos: pos + 4])
        body = data[pos + 4: pos + 8 + n]
        if len(body) != n + 4 or struct.unpack(">I", data[pos + 8 + n: pos + 12 + n])[0] != zlib.crc32(body):
            raise ValueError(f"{name}: bad CRC in its {body[:4]!r} chunk")
        kind, payload = body[:4], body[4:]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or not idat:
        raise ValueError(f"{name}: no IHDR or IDAT chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"{name}: bit depth {depth}, colour type {color}, interlace {interlace}; "
                         "the decoder reads 8-bit non-interlaced grey, RGB, palette, grey+alpha and RGBA")
    bpp = _CHANNELS[color]
    px = _unfilter(zlib.decompress(b"".join(idat)), height, width, bpp, name).reshape(height, width, bpp)
    if color == 3:
        if palette is None or px.max(initial=0) >= len(palette):
            raise ValueError(f"{name}: palette image without a PLTE entry for each index")
        return palette[px[..., 0]]
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def load_png(path: str | Path) -> np.ndarray:
    """An 8-bit PNG -> float32 [-1, 1] HWC RGB."""
    return decode_png(Path(path).read_bytes(), str(path)).astype(np.float32) / 127.5 - 1.0


def load_image(path: str | Path) -> np.ndarray:
    """-> float32 [-1, 1] HWC RGB (the reference's read convention): PNG
    with `load_png`, anything else (JPEG) through PIL, which must import."""
    with open(path, "rb") as f:
        is_png = f.read(len(_SIGNATURE)) == _SIGNATURE
    if is_png:
        return load_png(path)
    try:
        from PIL import Image
    except ImportError as err:
        raise RuntimeError(f"{path}: not a PNG, and there is no JPEG decoder on this machine (no PIL)") from err
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.float32) / 127.5 - 1.0
