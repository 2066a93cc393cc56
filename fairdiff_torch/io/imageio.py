"""ctypes binding of the port's image codec (`csrc/imageio.cpp`): PNG and
JPEG decode, JPEG encode and the threaded batch loader of the facerec
datasets (the counterpart of fairdiff/native/imageloader_lib.py).

The library is built with the host's C++ compiler at first use
(`kernels/build.py`); a missing compiler raises. Two read conventions:

- "pil": what PIL's `Image.open(p).convert("RGB")` gives, which the JAX
  package's `io.images.load_image` reads;
- "native": what the JAX package's native loader gives through libpng
  1.6's simplified API (alpha composited onto black in linear light, 16-bit
  PNG samples taken as linear unless a chunk says otherwise). It follows
  libpng's chunk rules too: sRGB fixes the file gamma over any gAMA not
  within 5% of it, the first gAMA wins, a duplicate or invalid colour chunk
  freezes the colour space; no gamma correction where file x screen gamma
  lies within 5% of 1; sBIT narrows the 16-bit gamma tables; an ancillary
  chunk with a bad CRC is dropped, IHDR must come once and before every
  chunk libpng knows, and nothing after the image data is read. JPEG reads
  the same in both.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from fairdiff_torch.kernels import build

CONVENTIONS = {"pil": 0, "native": 1}
STATUS = {
    1: "is not found or not readable",
    2: "has a singular affine matrix (degenerate landmarks?)",
    3: "is neither a PNG nor a JPEG file",
    4: "is corrupt or truncated",
    5: "uses a feature the decoder does not implement (arithmetic coding, 12-bit, lossless, CMYK/YCCK)",
}

_u8p = ctypes.POINTER(ctypes.c_uint8)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("imageio")
    lib.fdio_decode.restype = ctypes.c_int
    lib.fdio_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.POINTER(_u8p),
                                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.fdio_encode_jpeg.restype = ctypes.c_int
    lib.fdio_encode_jpeg.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(_u8p), ctypes.POINTER(ctypes.c_size_t)]
    lib.fdio_free.restype = None
    lib.fdio_free.argtypes = [ctypes.c_void_p]
    lib.fdio_load_batch.restype = ctypes.c_int
    lib.fdio_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_float), _u8p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
    ]
    return lib


def _raise(status: int, name: str) -> None:
    if status == 2:
        raise ValueError(f"{name} {STATUS[2]}")
    raise OSError(f"{name} {STATUS.get(status, f'failed with status {status}')}")


def decode(source: str | Path | bytes, convention: str = "pil") -> np.ndarray:
    """A PNG or JPEG file (a path or its bytes) -> [H, W, 3] uint8 RGB.
    Raises OSError naming the file when it cannot be read or decoded."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        data, name = bytes(source), "<bytes>"
    else:
        name = str(source)
        try:
            data = Path(source).read_bytes()
        except OSError as err:
            raise OSError(f"{name} {STATUS[1]}") from err
    lib = _lib()
    out, h, w = _u8p(), ctypes.c_int(), ctypes.c_int()
    status = lib.fdio_decode(data, len(data), CONVENTIONS[convention], ctypes.byref(out),
                             ctypes.byref(h), ctypes.byref(w))
    if status:
        _raise(status, name)
    try:
        return np.ctypeslib.as_array(out, (h.value, w.value, 3)).copy()
    finally:
        lib.fdio_free(out)


def encode_jpeg(pixels: np.ndarray, quality: int = 95) -> bytes:
    """[H, W, 3] uint8 RGB -> baseline 4:2:0 JPEG bytes, as PIL's
    `Image.fromarray(pixels).save(f, quality=quality)` writes them."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    if pixels.ndim != 3 or pixels.shape[-1] != 3:
        raise ValueError(f"want an [H, W, 3] image, got {pixels.shape}")
    lib = _lib()
    out, n = _u8p(), ctypes.c_size_t()
    status = lib.fdio_encode_jpeg(pixels.ctypes.data, pixels.shape[0], pixels.shape[1], int(quality),
                                  ctypes.byref(out), ctypes.byref(n))
    if status:
        raise ValueError(f"cannot encode an image of shape {pixels.shape} ({STATUS.get(status, status)})")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.fdio_free(out)


def load_batch(
    paths: Sequence[str | Path],
    out_hw: tuple[int, int],
    *,
    mats: Optional[np.ndarray] = None,  # [N, 2, 3] or [N, 6] forward affines; an all-zero row: no warp
    flips: Optional[np.ndarray] = None,  # [N] bool
    n_threads: int = 8,
) -> np.ndarray:
    """-> [N, H, W, 3] fp32 in [-1, 1]: decode (the "native" convention),
    warp or resize, normalise as (u8 - 127.5) / 127.5 and flip each image on
    up to `n_threads` threads (capped at the host's cores). Raises OSError
    naming the first item that cannot be read or decoded, and ValueError for
    a singular affine."""
    n = len(paths)
    h, w = out_hw
    out = np.empty((n, h, w, 3), np.float32)
    statuses = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    m_ptr = f_ptr = None
    if mats is not None:
        mats = np.ascontiguousarray(np.asarray(mats, np.float32).reshape(n, 6))
        m_ptr = mats.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if flips is not None:
        flips = np.ascontiguousarray(np.asarray(flips, np.uint8))
        f_ptr = flips.ctypes.data_as(_u8p)
    failures = _lib().fdio_load_batch(
        c_paths, n, m_ptr, f_ptr, h, w, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    if failures:
        bad = int(np.flatnonzero(statuses)[0])
        _raise(int(statuses[bad]), str(paths[bad]))
    return out
