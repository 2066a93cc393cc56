"""fairdiff_torch's PNG reader (zlib and numpy only) against PIL, which the
JAX package's `load_image` uses: `np.asarray(Image.open(p).convert("RGB"))
/ 127.5 - 1`, exactly.

PIL writes its PNGs with adaptive per-row filters (None, Sub, Up and Paeth
show up); a small encoder here writes every row with one given filter type,
so each of the five filters is read at least once on its own.
"""

import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from fairdiff.io.images import load_image as jax_load_image
from fairdiff_torch.io.images import decode_png, load_image, load_png, save_png, write_png

torch.set_num_threads(1)

MODES = {"RGB": 3, "RGBA": 4, "L": 1, "LA": 2}


def _pixels(h=33, w=29, c=4, seed=0):
    """Smooth random rows, so PIL's adaptive filter picks several types."""
    rng = np.random.default_rng(seed)
    return np.clip(np.cumsum(rng.normal(0, 9, (h, w, c)), axis=1) + 128, 0, 255).astype(np.uint8)


def _pil_reference(path):
    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 127.5 - 1.0


def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _encode(pixels, color, filt, depth=8, interlace=0, palette=None):
    """A PNG whose every row carries filter type `filt` (the encoder's own
    arithmetic, one byte at a time)."""
    h = pixels.shape[0]
    rows = pixels.reshape(h, -1).astype(np.int64)
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    raw = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for row in rows:
        out = []
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = {0: 0, 1: a, 2: b, 3: (a + b) // 2, 4: _paeth(a, b, c)}[filt]
            out.append((x - pred) % 256)
        raw += bytes([filt]) + bytes(out)
        prev = row
    png = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", pixels.shape[1], h, depth, color, 0, 0,
                                                               interlace))
    if palette is not None:
        png += _chunk(b"PLTE", palette.tobytes())
    return png + _chunk(b"IDAT", zlib.compress(bytes(raw))) + _chunk(b"IEND", b"")


def _filters(path):
    """The filter type of each row of an 8-bit PNG."""
    data = open(path, "rb").read()
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n = struct.unpack(">I", data[pos: pos + 4])[0]
        kind, body = data[pos + 4: pos + 8], data[pos + 8: pos + 8 + n]
        header = struct.unpack(">IIBBBBB", body) if kind == b"IHDR" else header
        idat += body if kind == b"IDAT" else b""
        pos += 12 + n
    w, h, _, color = header[:4]
    stride = 1 + w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    raw = zlib.decompress(idat)
    return {raw[y * stride] for y in range(h)}


@pytest.mark.parametrize("mode", [*MODES, "P"])
def test_pil_written_pngs_read_as_pil_reads_them(tmp_path, mode):
    px = _pixels()
    if mode == "P":
        img = Image.fromarray(px[..., :3], "RGB").convert("P", palette=Image.ADAPTIVE, colors=61)
    else:
        arr = px[..., : MODES[mode]]
        img = Image.fromarray(arr[..., 0] if mode == "L" else arr, mode)
    path = tmp_path / f"{mode}.png"
    img.save(path)
    got = load_png(path)
    assert got.dtype == np.float32 and got.shape == (33, 29, 3)
    np.testing.assert_array_equal(got, _pil_reference(path))
    np.testing.assert_array_equal(got, jax_load_image(path))
    np.testing.assert_array_equal(load_image(path), got)


def test_pil_uses_several_filters():
    """The adaptive filter of the files above is not always None."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        Image.fromarray(_pixels()[..., :3]).save(f"{d}/x.png")
        assert len(_filters(f"{d}/x.png")) >= 2


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("color", [0, 2, 3, 4, 6])
def test_every_filter_and_colour_type(tmp_path, filt, color):
    px = _pixels(h=9, w=11, seed=filt)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    palette = None
    if color == 3:
        palette = _pixels(h=1, w=256, c=3, seed=9)[0]
        img = px[..., :1] % 200  # indices into the palette
    else:
        img = px[..., :channels]
    path = tmp_path / "f.png"
    path.write_bytes(_encode(img, color, filt, palette=palette))
    assert _filters(path) == {filt}
    np.testing.assert_array_equal(load_png(path), _pil_reference(path))


def test_write_png_round_trip(tmp_path):
    px = _pixels()[..., :3]
    write_png(px, tmp_path / "w.png")
    np.testing.assert_array_equal(decode_png((tmp_path / "w.png").read_bytes()), px)
    np.testing.assert_array_equal(load_png(tmp_path / "w.png"), _pil_reference(tmp_path / "w.png"))
    img = np.random.default_rng(1).uniform(-1, 1, (8, 8, 3)).astype(np.float32)
    save_png(img, tmp_path / "s.png")
    np.testing.assert_allclose(load_png(tmp_path / "s.png"), img, atol=1 / 127.5)


def test_unsupported_and_corrupt_files_raise_naming_the_file(tmp_path):
    sixteen = tmp_path / "sixteen.png"
    Image.fromarray(_pixels()[..., 0].astype(np.uint16) * 200).save(sixteen)  # mode I;16
    with pytest.raises(ValueError, match="sixteen.png.*bit depth 16"):
        load_png(sixteen)
    interlaced = tmp_path / "interlaced.png"
    interlaced.write_bytes(_encode(_pixels(h=4, w=4)[..., :3], 2, 0, interlace=1))
    with pytest.raises(ValueError, match="interlaced.png.*interlace 1"):
        load_png(interlaced)
    corrupt = tmp_path / "corrupt.png"
    data = bytearray(_encode(_pixels(h=4, w=4)[..., :3], 2, 1))
    data[-20] ^= 0xFF  # a byte inside the IDAT chunk
    corrupt.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt.png.*CRC"):
        load_png(corrupt)
    with pytest.raises(ValueError, match="not_png.*not a PNG"):
        decode_png(b"GIF89a....", "not_png")


def test_jpeg_goes_through_pil_or_names_the_missing_decoder(tmp_path, monkeypatch):
    """JPEG decodes with PIL blocked (the port's codec), equal to the JAX
    package's PIL read; an undecodable file raises naming itself."""
    path = tmp_path / "a.jpg"
    Image.fromarray(_pixels()[..., :3]).save(path, quality=95)
    want = jax_load_image(path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(load_image(path), want)
    (tmp_path / "bad.jpg").write_bytes(path.read_bytes()[:200])
    with pytest.raises(OSError, match="bad.jpg.*truncated"):
        load_image(tmp_path / "bad.jpg")
    # PNG needs no PIL either
    write_png(_pixels()[..., :3], tmp_path / "b.png")
    assert load_image(tmp_path / "b.png").shape == (33, 29, 3)
