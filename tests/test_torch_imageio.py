"""fairdiff_torch's image codec (`csrc/imageio.cpp` through `io.imageio`)
against PIL, which the JAX package's `load_image`/`save_image` use, and
against the JAX package's native loader (fairdiff/native/imageloader.cpp:
libjpeg and libpng's simplified API), on the CPU.

Every comparison is exact unless it says otherwise: JPEG pixels equal in
u8 to both readers, PNG pixels equal to PIL (the "pil" convention) or to
libpng (the "native" one), the batch loader equal to the native loader in
fp32, and the encoder's bytes equal to PIL's.

The card's machine has no PIL and no libpng, so `chip_smoke.py` holds the
library to `fairdiff_torch/testdata/imageio_fixtures.npz`: PIL- and
cv2-written JPEGs and their PIL-decoded pixels, PIL's quality-95 bytes for
the encoder, and PNGs with colour chunks and the native loader's pixels for
them, written by `make_fixtures` below (`python tests/test_torch_imageio.py`
rewrites it).
"""

import base64
import io
import struct
import subprocess
import sys
import tempfile
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import fairdiff_torch
from fairdiff.io.images import load_image as jax_load_image
from fairdiff.io.images import save_image as jax_save_image
from fairdiff.native import imageloader_lib
from fairdiff_torch.facerec import datasets as tds
from fairdiff_torch.io import imageio
from fairdiff_torch.io.images import load_image, read_rgb8, save_image, to_uint8
from fairdiff_torch.kernels import build

torch.set_num_threads(1)

FIXTURES = Path(fairdiff_torch.__file__).parent / "testdata" / "imageio_fixtures.npz"


def smooth(h, w, c=3, seed=0):
    """Smooth random pixels: what a photo's blocks look like to a codec."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.normal(0, 12, (h, w, c)), axis=1) + np.cumsum(rng.normal(0, 6, (h, 1, c)), axis=0)
    return np.clip(walk + 128, 0, 255).astype(np.uint8)


def pil_jpeg(pixels, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "JPEG", **kw)
    return buf.getvalue()


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def native_u8(path, hw) -> np.ndarray:
    """The native loader's size-matched read, back to u8 (it is exactly
    (u8 - 127.5) / 127.5)."""
    out = imageloader_lib.load_batch([str(path)], hw, n_threads=1)[0]
    return np.round(out * 127.5 + 127.5).astype(np.uint8)


# ---------------------------------------------------------------- fixtures

# name -> (h, w, PIL mode, save arguments): 4:4:4, 4:2:2 and 4:2:0, grey,
# progressive, restart markers, optimised Huffman tables, an Adobe RGB file,
# quality 50 and 95, odd sizes
FIXTURE_CASES = {
    "444_q95": (24, 16, "RGB", dict(quality=95, subsampling=0)),
    "422_q90": (17, 9, "RGB", dict(quality=90, subsampling=1)),
    "420_q95": (33, 31, "RGB", dict(quality=95)),
    "420_q50": (33, 31, "RGB", dict(quality=50)),
    "grey_q90": (20, 13, "L", dict(quality=90)),
    "progressive_q85": (113, 97, "RGB", dict(quality=85, progressive=True)),
    "restart_q80": (40, 48, "RGB", dict(quality=80, restart_marker_blocks=1)),
    "optimize_q75": (30, 22, "RGB", dict(quality=75, optimize=True)),
    "adobe_rgb_q90": (16, 16, "RGB", dict(quality=90, keep_rgb=True)),
    "one_pixel_q95": (1, 1, "RGB", dict(quality=95)),
}
ENCODE_HW = (48, 40)
# name -> (h, w, progressive, quality): 4:4:0 (h1v2) files from cv2's libjpeg
JPEG_440_FIXTURES = {"440_q90": (45, 37, False, 90), "440_progressive_q85": (17, 33, True, 85)}
# name -> (colour type, bit depth, Adam7, tRNS, chunks as `png_with_chunks`
# takes them), at PNG_FIXTURE_HW: PNGs whose "native" pixels libpng (the
# native loader) decides through sBIT, gamma significance, sRGB/gAMA
# precedence, ancillary CRCs and iCCP
PNG_FIXTURES = {
    "f1_grey16_srgb": (0, 16, 0, False, ["sRGB"]),
    "f1_rgb16_adam7_gama43200": (2, 16, 1, False, ["gAMA 43200"]),
    "f2_rgb16_sbit8": (2, 16, 0, False, ["sBIT 8"]),
    "f2_rgba16_sbit10_gama45455": (6, 16, 0, False, ["sBIT 10", "gAMA 45455"]),
    "f3_grey16_gama_bad_crc": (0, 16, 0, False, ["gAMA 50000 !crc"]),
    "f3_rgb8_text_bad_crc": (2, 8, 0, False, ["tEXt !crc"]),
    "f4_rgb16_srgb_gama100000": (2, 16, 0, False, ["sRGB", "gAMA 100000"]),
    "f4_grey8_gama100000_gama45455": (0, 8, 0, False, ["gAMA 100000", "gAMA 45455"]),
    "f5_rgb8_gama43200": (2, 8, 0, False, ["gAMA 43200"]),
    "f6_rgb16_iccp_srgb": (2, 16, 0, False, ["iCCP srgb"]),
    "f6_rgb8_iccp_garbage_gama100000": (2, 8, 0, False, ["iCCP garbage", "gAMA 100000"]),
}
PNG_FIXTURE_HW = (16, 16)


def _long_palette_png() -> bytes:
    """2-bit palette of 6 entries with a tRNS of 5, which libpng ignores."""
    rng = np.random.default_rng(17)
    return encode_png(rng.integers(0, 4, (*PNG_FIXTURE_HW, 1)), 3, 2, 0, rng.integers(0, 256, (6, 3)),
                      bytes([0, 255, 90, 30, 200]), seed=2)


# name -> the file: PNGs that the chunk tokens cannot write (a palette longer
# than its bit depth allows; an Adler-32 that libpng never reaches)
PNG_FILE_FIXTURES = {
    "f7_palette_d2_plte6_trns5": _long_palette_png,
    "f8_rgb8_adler_bad_own_idat": lambda: _stream_case("adler_bad_own_idat")[0],
}


def make_fixtures() -> dict[str, np.ndarray]:
    out = {}
    for k, (name, (h, w, mode, kw)) in enumerate(FIXTURE_CASES.items()):
        px = smooth(h, w, 1 if mode == "L" else 3, seed=k)
        data = pil_jpeg(px[..., 0] if mode == "L" else px, **kw)
        out[f"{name}.jpg"] = np.frombuffer(data, np.uint8)
        out[f"{name}.pixels"] = pil_rgb(data)
    for name, (h, w, progressive, quality) in JPEG_440_FIXTURES.items():
        data = cv2_jpeg_440(smooth(h, w, seed=h + w), progressive, quality)
        out[f"{name}.jpg"] = np.frombuffer(data, np.uint8)
        out[f"{name}.pixels"] = pil_rgb(data)
    out["encode.source"] = smooth(*ENCODE_HW, seed=99)
    out["encode.q95"] = np.frombuffer(pil_jpeg(out["encode.source"], quality=95), np.uint8)
    files = {name: png_with_chunks(color, depth, interlace, trns, tokens, *PNG_FIXTURE_HW)
             for name, (color, depth, interlace, trns, tokens) in PNG_FIXTURES.items()}
    files.update({name: make() for name, make in PNG_FILE_FIXTURES.items()})
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in files.items():
            path = Path(tmp) / f"{name}.png"
            path.write_bytes(data)
            out[f"{name}.png"] = np.frombuffer(data, np.uint8)
            out[f"{name}.native"] = native_u8(path, struct.unpack(">II", data[16:24])[::-1])
    return out


def test_fixtures_are_the_seeded_scripts_and_decode_exactly():
    stored = dict(np.load(FIXTURES))
    fresh = make_fixtures()
    assert stored.keys() == fresh.keys()
    for k in fresh:
        np.testing.assert_array_equal(stored[k], fresh[k], err_msg=k)
    for name in [*FIXTURE_CASES, *JPEG_440_FIXTURES]:
        np.testing.assert_array_equal(imageio.decode(stored[f"{name}.jpg"].tobytes()), stored[f"{name}.pixels"])
    for name in [*PNG_FIXTURES, *PNG_FILE_FIXTURES]:
        np.testing.assert_array_equal(imageio.decode(stored[f"{name}.png"].tobytes(), "native"),
                                      stored[f"{name}.native"], err_msg=name)
    assert imageio.encode_jpeg(stored["encode.source"], 95) == stored["encode.q95"].tobytes()
    assert FIXTURES.stat().st_size < 150_000


# ------------------------------------------------------------- JPEG decode

JPEG_KINDS = {
    "420_q95": dict(quality=95),
    "420_q50": dict(quality=50),
    "422_q90": dict(quality=90, subsampling=1),
    "444_q75": dict(quality=75, subsampling=0),
    "progressive": dict(quality=90, progressive=True),
    "progressive_422": dict(quality=80, progressive=True, subsampling=1),
    "optimize": dict(quality=90, optimize=True),
    "restart": dict(quality=80, restart_marker_blocks=1),
    "adobe_rgb": dict(quality=85, keep_rgb=True),
    "grey": dict(quality=90),
}


@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (17, 9), (113, 97), (250, 250)])
@pytest.mark.parametrize("kind", list(JPEG_KINDS))
def test_jpeg_decode_equals_pil_and_the_native_loader(tmp_path, kind, hw):
    px = smooth(*hw, seed=hw[0] * 7 + hw[1])
    if kind == "grey":
        px = px[..., 0]
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(pil_jpeg(px, **JPEG_KINDS[kind]))
    got = imageio.decode(path)
    np.testing.assert_array_equal(got, pil_rgb(path.read_bytes()))
    np.testing.assert_array_equal(got, native_u8(path, hw))
    np.testing.assert_array_equal(imageio.decode(path, "native"), got)  # one JPEG convention


# -------------------------------------------------------------- PNG decode

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]


def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _pack(samples, depth):
    h, w, ch = samples.shape
    flat = samples.reshape(h, w * ch)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    out = np.zeros((h, -(-w * ch // per)), np.uint8)
    for i in range(w * ch):
        out[:, i // per] |= (flat[:, i].astype(np.uint8) << (8 - depth * (i % per + 1))).astype(np.uint8)
    return out


def _filtered(rows, bpp, rng):
    """Each row under a filter type drawn from `rng` (all five show up)."""
    out, prev = bytearray(), np.zeros(rows.shape[1], np.int64)
    for cur in rows.astype(np.int64):
        a = np.concatenate([np.zeros(bpp, np.int64), cur])[: len(cur)]
        c = np.concatenate([np.zeros(bpp, np.int64), prev])[: len(cur)]
        kind = int(rng.integers(0, 5))
        pred = [0, a, prev, (a + prev) >> 1, None][kind]
        if kind == 4:
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(kind)
        out += ((cur - pred) & 255).astype(np.uint8).tobytes()
        prev = cur
    return bytes(out)


def encode_png(samples, color, depth, interlace=0, palette=None, trns=None, seed=0) -> bytes:
    """Samples [h, w, channels] at `depth` -> PNG bytes (any colour type,
    bit depth, Adam7 and tRNS, which PIL does not all write)."""
    h, w, ch = samples.shape
    bpp, rng = max(1, ch * depth // 8), np.random.default_rng(seed)
    passes = _ADAM7 if interlace else [(0, 0, 1, 1)]
    raw = b"".join(_filtered(_pack(samples[y0::dy, x0::dx], depth), bpp, rng)
                   for x0, y0, dx, dy in passes if samples[y0::dy, x0::dx].size)
    png = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        png += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        png += _chunk(b"tRNS", trns)
    return png + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b"")


def png_case(color, depth, interlace, trns_on, h=37, w=23):
    """Seeded samples for one case: alpha covers 0, full and values between;
    a tRNS key colour shows up on a grid of pixels."""
    rng = np.random.default_rng(color * 100 + depth * 3 + interlace)
    top = (1 << depth) - 1
    palette = trns = None
    if color == 3:
        n = min(1 << depth, 200)
        samples = rng.integers(0, n, (h, w, 1))
        palette = rng.integers(0, 256, (n, 3))
        if trns_on:
            trns = bytes([0, 255]) + bytes(rng.integers(0, 256, min(n, 150) - 2).astype(np.uint8))
    else:
        samples = rng.integers(0, top + 1, (h, w, _CHANNELS[color]))
        if color in (4, 6):
            samples[..., -1] = rng.choice([0, top, *rng.integers(0, top + 1, 8)], (h, w))
        if trns_on:
            samples[::3, ::2] = samples[0, 0]
            trns = b"".join(struct.pack(">H", int(k)) for k in samples[0, 0])
    return encode_png(samples, color, depth, interlace, palette, trns, seed=depth)


PNG_CASES = [(c, d, i, t) for c, depths in {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
                                            6: (8, 16)}.items()
             for d in depths for i in (0, 1) for t in ((False, True) if c in (0, 2, 3) else (False,))]


@pytest.mark.parametrize("color,depth,interlace,trns", PNG_CASES,
                         ids=[f"c{c}-d{d}-i{i}-t{int(t)}" for c, d, i, t in PNG_CASES])
def test_png_decode_both_conventions(tmp_path, color, depth, interlace, trns):
    """"pil" equals PIL's `.convert("RGB")`; "native" equals libpng's
    simplified read through the native loader: alpha and tRNS composited
    onto black in linear light, 16-bit samples taken as linear, a palette's
    alpha composited entry by entry, and for 16-bit Adam7 without alpha the
    rows libpng's reader leaves (row 2k a copy of row 2k - 1)."""
    path = tmp_path / "x.png"
    path.write_bytes(png_case(color, depth, interlace, trns))
    with Image.open(path) as img:
        want_pil = np.asarray(img.convert("RGB"))
    np.testing.assert_array_equal(imageio.decode(path, "pil"), want_pil)
    np.testing.assert_array_equal(imageio.decode(path, "native"), native_u8(path, want_pil.shape[:2]))


@pytest.mark.parametrize("mode", ["RGBA", "LA", "I;16", "P", "1"])
def test_pil_written_pngs_both_conventions(tmp_path, mode):
    rng = np.random.default_rng(5)
    if mode == "I;16":
        img = Image.fromarray(rng.integers(0, 65536, (19, 21)).astype(np.uint16))
    elif mode == "P":
        img = Image.fromarray(smooth(19, 21)).convert("P")
        img.info["transparency"] = bytes(rng.integers(0, 256, 256).astype(np.uint8))
    else:
        img = Image.fromarray(smooth(19, 21, 4)[..., :len(mode)] if mode != "1" else smooth(19, 21)).convert(mode)
    path = tmp_path / "p.png"
    img.save(path, **({"transparency": img.info["transparency"]} if mode == "P" else {}))
    with Image.open(path) as back:
        np.testing.assert_array_equal(imageio.decode(path, "pil"), np.asarray(back.convert("RGB")))
    np.testing.assert_array_equal(imageio.decode(path, "native"), native_u8(path, (19, 21)))


# ------------------------------------------------- PNG chunks under "native"

# The HP-Microsoft sRGB v2 profile (3144 bytes, media-relative intent), as
# files carry it, zlib-compressed and in base64: one of the profiles libpng
# 1.6 knows as sRGB by its checksums (png.c png_sRGB_checks)
SRGB_ICC = zlib.decompress(base64.b64decode(
    "eNqdlndUVNcWh8+9d3qhzTACUobeu8AA0nuTXkVhmBlgKAMOMzSxIaICEUVEmiJIUMSA0VAkVkSxEBRUsAckCCgxGEVULG9G"
    "1ouurLz38vL746xv7bP3ufvsvc9aFwCSpy+XlwZLAZDKE/CDPJzpEZFRdOwAgAEeYIApAExWRrpfsHsIEMnLzYWeIXICXwQB"
    "8HpYvAJw09AzgE4H/5+kWel8geiYABGbszkZLBEXiDglS5Auts+KmBqXLGYYJWa+KEERy4k5YZENPvsssqOY2ak8tojFOaez"
    "U9li7hXxtkwhR8SIr4gLM7mcLBHfErFGijCVK+I34thUDjMDABRJbBdwWIkiNhExiR8S5CLi5QDgSAlfcdxXLOBkC8SXcklL"
    "z+FzExIFdB2WLt3U2ppB9+RkpXAEAsMAJiuZyWfTXdJS05m8HAAW7/xZMuLa0kVFtjS1trQ0NDMy/apQ/3Xzb0rc20V6Gfi5"
    "ZxCt/4vtr/zSGgBgzIlqs/OLLa4KgM4tAMjd+2LTOACApKhvHde/ug9NPC+JAkG6jbFxVlaWEZfDMhIX9A/9T4e/oa++ZyQ+"
    "7o/y0F058UxhioAurhsrLSVNyKdnpDNZHLrhn4f4Hwf+dR4GQZx4Dp/DE0WEiaaMy0sQtZvH5gq4aTw6l/efmvgPw/6kxbkW"
    "idL4EVBjjIDUdSpAfu0HKAoRINH7xV3/o2+++DAgfnnhKpOLc//vN/1nwaXiJYOb8DnOJSiEzhLyMxf3xM8SoAEBSAIqkAfK"
    "QB3oAENgBqyALXAEbsAb+IMQEAlWAxZIBKmAD7JAHtgECkEx2An2gGpQBxpBM2gFx0EnOAXOg0vgGrgBboP7YBRMgGdgFrwG"
    "CxAEYSEyRIHkIRVIE9KHzCAGZA+5Qb5QEBQJxUIJEA8SQnnQZqgYKoOqoXqoGfoeOgmdh65Ag9BdaAyahn6H3sEITIKpsBKs"
    "BRvDDNgJ9oFD4FVwArwGzoUL4B1wJdwAH4U74PPwNfg2PAo/g+cQgBARGqKKGCIMxAXxR6KQeISPrEeKkAqkAWlFupE+5CYy"
    "iswgb1EYFAVFRxmibFGeqFAUC7UGtR5VgqpGHUZ1oHpRN1FjqFnURzQZrYjWR9ugvdAR6AR0FroQXYFuQrejL6JvoyfQrzEY"
    "DA2jjbHCeGIiMUmYtZgSzD5MG+YcZhAzjpnDYrHyWH2sHdYfy8QKsIXYKuxR7FnsEHYC+wZHxKngzHDuuCgcD5ePq8AdwZ3B"
    "DeEmcQt4Kbwm3gbvj2fjc/Cl+EZ8N/46fgK/QJAmaBPsCCGEJMImQiWhlXCR8IDwkkgkqhGtiYFELnEjsZJ4jHiZOEZ8S5Ih"
    "6ZFcSNEkIWkH6RDpHOku6SWZTNYiO5KjyALyDnIz+QL5EfmNBEXCSMJLgi2xQaJGokNiSOK5JF5SU9JJcrVkrmSF5AnJ65Iz"
    "UngpLSkXKabUeqkaqZNSI1Jz0hRpU2l/6VTpEukj0lekp2SwMloybjJsmQKZgzIXZMYpCEWd4kJhUTZTGikXKRNUDFWb6kVN"
    "ohZTv6MOUGdlZWSXyYbJZsvWyJ6WHaUhNC2aFy2FVko7ThumvVuitMRpCWfJ9iWtS4aWzMstlXOU48gVybXJ3ZZ7J0+Xd5NP"
    "lt8l3yn/UAGloKcQqJClsF/hosLMUupS26WspUVLjy+9pwgr6ikGKa5VPKjYrzinpKzkoZSuVKV0QWlGmabsqJykXK58Rnla"
    "haJir8JVKVc5q/KULkt3oqfQK+m99FlVRVVPVaFqveqA6oKatlqoWr5am9pDdYI6Qz1evVy9R31WQ0XDTyNPo0XjniZek6GZ"
    "qLlXs09zXktbK1xrq1an1pS2nLaXdq52i/YDHbKOg84anQadW7oYXYZusu4+3Rt6sJ6FXqJejd51fVjfUp+rv09/0ABtYG3A"
    "M2gwGDEkGToZZhq2GI4Z0Yx8jfKNOo2eG2sYRxnvMu4z/mhiYZJi0mhy31TG1Ns037Tb9HczPTOWWY3ZLXOyubv5BvMu8xfL"
    "9Jdxlu1fdseCYuFnsdWix+KDpZUl37LVctpKwyrWqtZqhEFlBDBKGJet0dbO1husT1m/tbG0Edgct/nN1tA22faI7dRy7eWc"
    "5Y3Lx+3U7Jh29Xaj9nT7WPsD9qMOqg5MhwaHx47qjmzHJsdJJ12nJKejTs+dTZz5zu3O8y42Lutczrkirh6uRa4DbjJuoW7V"
    "bo/c1dwT3FvcZz0sPNZ6nPNEe/p47vIc8VLyYnk1e816W3mv8+71IfkE+1T7PPbV8+X7dvvBft5+u/0erNBcwVvR6Q/8vfx3"
    "+z8M0A5YE/BjICYwILAm8EmQaVBeUF8wJTgm+Ejw6xDnkNKQ+6E6ocLQnjDJsOiw5rD5cNfwsvDRCOOIdRHXIhUiuZFdUdio"
    "sKimqLmVbiv3rJyItogujB5epb0qe9WV1QqrU1afjpGMYcaciEXHhsceiX3P9Gc2MOfivOJq42ZZLqy9rGdsR3Y5e5pjxynj"
    "TMbbxZfFTyXYJexOmE50SKxInOG6cKu5L5I8k+qS5pP9kw8lf0oJT2lLxaXGpp7kyfCSeb1pymnZaYPp+umF6aNrbNbsWTPL"
    "9+E3ZUAZqzK6BFTRz1S/UEe4RTiWaZ9Zk/kmKyzrRLZ0Ni+7P0cvZ3vOZK577rdrUWtZa3vyVPM25Y2tc1pXvx5aH7e+Z4P6"
    "hoINExs9Nh7eRNiUvOmnfJP8svxXm8M3dxcoFWwsGN/isaWlUKKQXziy1XZr3TbUNu62ge3m26u2fyxiF10tNimuKH5fwiq5"
    "+o3pN5XffNoRv2Og1LJ0/07MTt7O4V0Ouw6XSZfllo3v9tvdUU4vLyp/tSdmz5WKZRV1ewl7hXtHK30ru6o0qnZWva9OrL5d"
    "41zTVqtYu712fh9739B+x/2tdUp1xXXvDnAP3Kn3qO9o0GqoOIg5mHnwSWNYY9+3jG+bmxSaips+HOIdGj0cdLi32aq5+Yji"
    "kdIWuEXYMn00+uiN71y/62o1bK1vo7UVHwPHhMeefh/7/fBxn+M9JxgnWn/Q/KG2ndJe1AF15HTMdiZ2jnZFdg2e9D7Z023b"
    "3f6j0Y+HTqmeqjkte7r0DOFMwZlPZ3PPzp1LPzdzPuH8eE9Mz/0LERdu9Qb2Dlz0uXj5kvulC31OfWcv210+dcXmysmrjKud"
    "1yyvdfRb9Lf/ZPFT+4DlQMd1q+tdN6xvdA8uHzwz5DB0/qbrzUu3vG5du73i9uBw6PCdkeiR0TvsO1N3U+6+uJd5b+H+xgfo"
    "B0UPpR5WPFJ81PCz7s9to5ajp8dcx/ofBz++P84af/ZLxi/vJwqekJ9UTKpMNk+ZTZ2adp++8XTl04ln6c8WZgp/lf619rnO"
    "8x9+c/ytfzZiduIF/8Wn30teyr889GrZq565gLlHr1NfL8wXvZF/c/gt423fu/B3kwtZ77HvKz/ofuj+6PPxwafUT5/+BQOY"
    "8/w="
))


def _icc_profile(space=b"RGB ", cls=b"mntr", pcs=b"XYZ ", length=512, tags=(), intent=0, sig=b"acsp") -> bytes:
    """A profile of a 132-byte header and a tag table (id, start, size),
    padded to `length` with seeded noise (so that its chunk is longer than
    the 92 bytes below which libpng ignores it): what libpng's checks read,
    and nothing it knows as sRGB."""
    head = bytearray(128)
    head[0:4] = struct.pack(">I", length)
    head[8] = 2
    head[12:16], head[16:20], head[20:24], head[36:40] = cls, space, pcs, sig
    head[64:68] = struct.pack(">I", intent)
    table = struct.pack(">I", len(tags)) + b"".join(struct.pack(">4sII", *t) for t in tags)
    noise = np.random.default_rng(length).integers(0, 256, length - 132 - 12 * len(tags)).astype(np.uint8)
    return bytes(head) + table + noise.tobytes()


def _edited(profile: bytes, at: int, value: bytes) -> bytes:
    return profile[:at] + value + profile[at + len(value):]


def _iccp_payload(kind: str) -> bytes:
    """An iCCP chunk's data: keyword, 0, compression method, zlib stream."""
    name, method, srgb = b"ICC profile", 0, zlib.compress(SRGB_ICC)
    stream = {
        "srgb": srgb,
        "srgb0": zlib.compress(_edited(SRGB_ICC, 64, b"\0\0\0\0")),  # the perceptual sibling
        "srgb-edited": zlib.compress(_edited(SRGB_ICC, 500, bytes([SRGB_ICC[500] ^ 1]))),
        "plain": zlib.compress(_icc_profile()),
        "plain-grey": zlib.compress(_icc_profile(space=b"GRAY")),
        "srgb-more": zlib.compress(SRGB_ICC + bytes(400)),  # the stream goes on past the profile
        "srgb-adler": srgb[:-4] + bytes(b ^ 0x55 for b in srgb[-4:]),
        "srgb-tail": srgb + b"trailing bytes",
        "garbage": b"\x78\x9c" + bytes(np.random.default_rng(7).integers(0, 256, 300).astype(np.uint8)),
        "cut": srgb[:-600],
        "length-100": zlib.compress(_edited(_icc_profile(), 0, struct.pack(">I", 100))),
        "signature": zlib.compress(_icc_profile(sig=b"bcsp")),
        "tag-outside": zlib.compress(_icc_profile(tags=[(b"desc", 500, 20)])),
        "abstract": zlib.compress(_icc_profile(cls=b"abst")),
        "pcs-cmyk": zlib.compress(_icc_profile(pcs=b"CMYK")),
        "intent-ffff": zlib.compress(_icc_profile(intent=0xFFFF)),
    }.get(kind, srgb)
    if kind == "no-name":
        name = b""
    elif kind == "name-80":
        name = b"k" * 80
    elif kind == "method-1":
        method = 1
    elif kind == "short":  # shorter than the 92 bytes libpng reads a profile from
        return b"icc\0\0" + zlib.compress(b"a profile")
    return name + b"\0" + bytes([method]) + stream


CHRM = {"srgb": [31270, 32900, 64000, 33000, 30000, 60000, 15000, 6000],
        "adobe": [31270, 32900, 64000, 33000, 21000, 71000, 15000, 6000], "zero": [0] * 8}


def _token_chunk(token: str, channels: int) -> bytes:
    """One chunk from a token: "gAMA 45455", "sRGB", "sRGB intent 5",
    "sRGB len 2", "sBIT 9" (one value a channel), "sBIT 4,9,6", "cHRM adobe",
    "tEXt", "PLTE" (a suggested palette), "tRNS <hex>", "tRNS x<n>" (n zero
    bytes), "iCCP <kind>" (`_iccp_payload`); "!crc" at its end spoils the
    CRC."""
    token, bad = (token[:-4].strip(), True) if token.endswith("!crc") else (token, False)
    kind, _, arg = token.partition(" ")
    if kind == "gAMA":
        data = struct.pack(">I", int(arg))
    elif kind == "sRGB":
        data = bytes([int(arg.split()[1])]) if arg.startswith("intent") else bytes(2 if arg == "len 2" else 1)
    elif kind == "sBIT":
        data = bytes(int(v) for v in arg.split(",")) if "," in arg else bytes([int(arg)] * channels)
    elif kind == "cHRM":
        data = struct.pack(">8I", *CHRM[arg])
    elif kind == "tEXt":
        data = b"Comment\x00a chunk spliced in"
    elif kind == "PLTE":
        data = bytes(range(48))
    elif kind == "iCCP":
        data = _iccp_payload(arg)
    else:  # raw hex, or "x<n>": n zero bytes
        data = bytes(int(arg[1:])) if arg.startswith("x") else bytes.fromhex(arg)
    chunk = _chunk(kind.encode(), data)
    return chunk[:-4] + struct.pack(">I", zlib.crc32(chunk[4:-4]) ^ 1) if bad else chunk


def png_with_chunks(color, depth, interlace, trns, tokens, h=32, w=32) -> bytes:
    """`png_case`'s file with chunks spliced in: after IHDR, or with "@sig "
    before IHDR, "@idat " before the first IDAT (after PLTE and tRNS) or
    "@end " between the last IDAT and IEND. "-tRNS" moves the file's own
    tRNS chunk to IEND; "IHDR" is a copy of the file's IHDR."""
    png = png_case(color, depth, interlace, trns, h, w)
    channels = 3 if color == 3 else _CHANNELS[color]
    at = {"sig": b"", "ihdr": b"", "idat": b"", "end": b""}
    for token in tokens:
        if token == "IHDR":
            at["ihdr"] += png[8:33]
            continue
        if token == "-tRNS":
            i = png.index(b"tRNS") - 4
            n = 12 + struct.unpack(">I", png[i:i + 4])[0]
            at["end"] += png[i:i + n]
            png = png[:i] + png[i + n:]
            continue
        where, token = token[1:].split(" ", 1) if token.startswith("@") else ("ihdr", token)
        at[where] += _token_chunk(token, channels)
    i, j = 33, png.index(b"IDAT") - 4
    png = png[:8] + at["sig"] + png[8:i] + at["ihdr"] + png[i:j] + at["idat"] + png[j:]
    k = png.index(b"IEND") - 4
    return png[:k] + at["end"] + png[k:]


_GREY16, _RGB16, _GA16, _RGBA16 = (0, 16), (2, 16), (4, 16), (6, 16)
# (group, color, depth, interlace, tRNS, chunks)
CHUNK_CASES = (
    # F1: 16-bit without alpha, where file x screen gamma is within 5% of 1, is scaled without a table
    [("f1", c, 16, i, False, g) for c in (0, 2) for i in (0, 1)
     for g in (["sRGB"], ["gAMA 43200"], ["gAMA 45455"], ["gAMA 47700"], ["gAMA 50000"], ["gAMA 100000"], [])]
    # F2: sBIT sets the 16-bit tables' shift (grey's value, or the largest colour one)
    + [("f2", c, 16, 0, t, [f"sBIT {s}", *g]) for s in (1, 8, 9, 10, 11, 15)
       for c, t in ((0, False), (2, False), (4, False), (6, False), (0, True), (2, True))
       for g in ([], ["gAMA 45455"])]
    + [("f2", c, d, 0, False, [s]) for c, d, s in ((0, 16, "sBIT 0"), (2, 16, "sBIT 0"), (0, 16, "sBIT 17"),
                                                    (2, 16, "sBIT 17"), (0, 8, "sBIT 5"), (2, 8, "sBIT 5"),
                                                    (3, 8, "sBIT 5"), (2, 16, "sBIT 4,9,6"),
                                                    (6, 16, "sBIT 10,10,10,3"), (0, 16, "@end sBIT 8"))]
    + [("f2", 0, 16, 0, False, ["sBIT 9", "sBIT 12"]), ("f2", 2, 16, 0, False, ["sBIT 0,0,0", "sBIT 9"]),
       ("f2", 2, 16, 0, False, ["sBIT 9 !crc", "sBIT 12"]), ("f2", 2, 16, 0, False, ["PLTE", "sBIT 8"])]
    # F4: sRGB over any gAMA, the first gAMA over a later one, each where libpng reads it
    + [("f4", 2, d, 0, False, g) for d in (8, 16)
       for g in (["sRGB", "gAMA 100000"], ["gAMA 100000", "sRGB"], ["gAMA 100000", "gAMA 45455"])]
    + [("f4", 0, 16, 0, False, g) for g in (
        ["sRGB", "gAMA 46000"], ["sRGB", "gAMA 100000", "gAMA 46000"], ["sRGB", "sRGB"], ["sRGB len 2"],
        ["sRGB intent 5"], ["sRGB intent 5", "gAMA 50000"], ["gAMA 0", "sRGB"], ["gAMA 15", "gAMA 50000"],
        ["gAMA 16"], ["gAMA 625000001", "sRGB"], ["@end gAMA 50000"], ["@end sRGB"])]
    + [("f4", 2, 16, 0, False, ["PLTE", "gAMA 50000"]), ("f4", 3, 8, 0, False, ["@idat gAMA 100000"]),
       ("f4", 3, 8, 0, False, ["@idat sRGB"])]
    # 8-bit files without alpha follow the same threshold as 16-bit ones
    + [("f5", c, d, 0, False, [f"gAMA {g}"]) for c, d in ((0, 8), (2, 8), (3, 8), (0, 2)) for g in (43200, 47800)]
    # cHRM: no effect of its own, but a duplicate, an impossible one or one unlike an earlier
    # sRGB's leaves the colour space invalid, and no later gAMA or sRGB counts
    + [("chrm", c, d, 0, False, g) for c, d in ((2, 8), (6, 8), (4, 16))
       for g in (["gAMA 45455"], ["gAMA 100000"], ["sRGB"], ["cHRM srgb", "gAMA 100000"], ["cHRM adobe", "sRGB"])]
    + [("chrm", 0, 16, 0, False, g) for g in (["cHRM srgb", "cHRM srgb", "gAMA 50000"], ["cHRM zero", "gAMA 50000"],
                                              ["sRGB", "cHRM adobe", "gAMA 46000"], ["cHRM adobe", "gAMA 50000"])]
    # tRNS: of its colour type's length, once, before IDAT, after a palette and no longer than it
    + [("trns", c, 8, 0, t, g) for c, t, g in (
        (2, False, ["@idat tRNS 0001"]), (0, False, ["@idat tRNS 000100020003"]), (0, True, ["-tRNS"]),
        (2, True, ["@idat tRNS 000100020003"]), (3, False, ["tRNS 000a14"]), (3, False, ["@idat tRNS x300"]))]
    # iCCP: a profile libpng knows as sRGB counts as sRGB (its CRC and what follows its bytes in the
    # stream not looked at); any other valid one changes nothing, so a later sRGB still counts
    + [("iccp", c, d, 0, False, g) for c, d in ((2, 16), (6, 16)) for g in (
        ["iCCP srgb"], ["iCCP srgb0"], ["iCCP srgb !crc"], ["iCCP srgb-more"], ["iCCP srgb-adler"],
        ["iCCP srgb-tail"], ["iCCP srgb-edited", "sRGB"], ["iCCP plain", "sRGB"], ["iCCP plain", "iCCP srgb"],
        ["gAMA 100000", "iCCP srgb"], ["iCCP srgb", "gAMA 46000"], ["iCCP srgb-edited"])]
    + [("iccp", 2, 8, 0, False, ["iCCP srgb", "gAMA 100000"]), ("iccp", 2, 8, 0, False, ["iCCP plain", "gAMA 100000"]),
       ("iccp", 0, 16, 0, False, ["iCCP plain-grey", "sRGB"]), ("iccp", 0, 16, 0, False, ["iCCP srgb"])]
    # a rejected profile, or one profile too many, invalidates the colour space: no later gAMA or
    # sRGB counts; one too short to hold a profile (or out of place) is ignored
    + [("iccp", c, d, 0, False, [f"iCCP {k}", g]) for c, d, g in ((2, 8, "gAMA 100000"), (2, 16, "sRGB"))
       for k in ("garbage", "no-name", "name-80", "method-1", "cut", "length-100", "signature", "tag-outside",
                 "abstract", "pcs-cmyk", "intent-ffff", "plain-grey", "short")]
    + [("iccp", 0, 16, 0, False, ["iCCP plain", "sRGB"]), ("iccp", 0, 8, 0, False, ["iCCP srgb", "gAMA 100000"]),
       ("iccp", 6, 16, 0, False, ["sRGB", "iCCP plain", "gAMA 46000"]),
       ("iccp", 6, 8, 0, False, ["iCCP srgb", "iCCP plain", "gAMA 46000"]),
       ("iccp", 2, 8, 0, False, ["PLTE", "iCCP garbage"]), ("iccp", 2, 16, 0, False, ["@end iCCP srgb"])]
)
CHUNK_IDS = [f"{g}-c{c}d{d}i{i}{'t' if t else ''}-{'+'.join(k) or 'none'}".replace(" ", "_")
             for g, c, d, i, t, k in CHUNK_CASES]


@pytest.mark.parametrize("group,color,depth,interlace,trns,tokens", CHUNK_CASES, ids=CHUNK_IDS)
def test_png_chunks_native_equal_the_native_loader(tmp_path, group, color, depth, interlace, trns, tokens):
    """libpng's reading of gAMA, sRGB, cHRM, sBIT, tRNS and iCCP (pngrutil.c,
    png.c's colour space, png_build_gamma_table's shift): the "native"
    decode equal to the native loader in u8, the batch loader in fp32, and
    the "pil" decode still equal to PIL, which ignores these chunks (and
    raises on a bad CRC, as "pil" does)."""
    path = tmp_path / "x.png"
    path.write_bytes(png_with_chunks(color, depth, interlace, trns, tokens))
    np.testing.assert_array_equal(imageio.decode(path, "native"), native_u8(path, (32, 32)))
    want = imageloader_lib.load_batch([str(path)], (32, 32), n_threads=1)
    np.testing.assert_allclose(imageio.load_batch([path], (32, 32), n_threads=1), want, rtol=0, atol=1e-6)
    if any(t.endswith("!crc") for t in tokens):
        with pytest.raises(OSError, match="corrupt or truncated"):
            imageio.decode(path, "pil")
    elif tokens == ["@idat tRNS 0001"] and color == 2:  # PIL cannot open an RGB file with a 2-byte tRNS
        with pytest.raises(OSError):
            Image.open(path)
    elif "iCCP method-1" in tokens:  # PIL raises on a compression method other than 0, and so does "pil"
        with pytest.raises(OSError):
            Image.open(path)
        with pytest.raises(OSError, match="corrupt or truncated"):
            imageio.decode(path, "pil")
    else:
        with Image.open(path) as img:
            np.testing.assert_array_equal(imageio.decode(path, "pil"), np.asarray(img.convert("RGB")))


def _spoil_idat_crc(png: bytes) -> bytes:
    i = png.index(b"IDAT") - 4
    end = i + 8 + struct.unpack(">I", png[i:i + 4])[0]
    return png[:end] + bytes([png[end] ^ 1]) + png[end + 1:]


# name -> (file, whether the native loader reads it): "native" drops an
# ancillary chunk whose CRC fails and reads nothing after the image data;
# PIL, and so "pil", raises on every bad CRC and a missing IEND
CRC_CASES = {
    **{f"{t.split()[0]}_bad_crc_d{d}": (lambda t=t, d=d: png_with_chunks(2, d, 0, False, [t + " !crc"]), True)
       for t in ("gAMA 100000", "sRGB", "tEXt", "sBIT 5") for d in (8, 16)},
    "zzZz_bad_crc": (lambda: png_with_chunks(0, 16, 0, False, ["zzZz !crc"]), True),
    "IEND_bad_crc": (lambda: png_case(2, 8, 0, False, 32, 32)[:-4] + b"\0\0\0\0", True),
    "IEND_missing": (lambda: png_case(2, 16, 1, False, 32, 32)[:-12], True),
    "tEXt_bad_crc_after_IDAT": (lambda: png_with_chunks(0, 8, 0, False, ["@end tEXt !crc"]), True),
    "IDAT_bad_crc": (lambda: _spoil_idat_crc(png_case(2, 8, 0, False, 32, 32)), False),
    "truncated_in_IDAT": (lambda: png_case(2, 16, 0, False, 32, 32)[:-40], False),
}


@pytest.mark.parametrize("name", list(CRC_CASES))
def test_png_bad_crcs_and_truncation(tmp_path, name):
    make, native_reads = CRC_CASES[name]
    path = tmp_path / f"{name}.png"
    path.write_bytes(make())
    with pytest.raises(OSError, match=f"{name}.png is corrupt or truncated"):
        imageio.decode(path, "pil")
    if not native_reads:
        with pytest.raises(OSError, match="not decodable"):
            native_u8(path, (32, 32))
        for call in (lambda: imageio.decode(path, "native"), lambda: imageio.load_batch([path], (32, 32))):
            with pytest.raises(OSError, match=f"{name}.png is corrupt or truncated"):
                call()
        return
    np.testing.assert_array_equal(imageio.decode(path, "native"), native_u8(path, (32, 32)))
    np.testing.assert_allclose(imageio.load_batch([path], (32, 32), n_threads=1),
                               imageloader_lib.load_batch([str(path)], (32, 32), n_threads=1), rtol=0, atol=1e-6)


# name -> (chunks, whether libpng reads the file): it wants IHDR once, before
# every chunk it has a handler for; an unknown chunk may come first. PIL
# reads them all but those with a bad CRC, and so does "pil".
ORDER_CASES = {
    "gAMA_before_IHDR": (["@sig gAMA 100000"], False), "sBIT_before_IHDR": (["@sig sBIT 8"], False),
    "tEXt_before_IHDR": (["@sig tEXt"], False), "tEXt_bad_crc_before_IHDR": (["@sig tEXt !crc"], False),
    "zzZz_before_IHDR": (["@sig zzZz"], True), "zzZz_bad_crc_before_IHDR": (["@sig zzZz !crc"], True),
    "IHDR_twice": (["IHDR"], False), "IHDR_after_gAMA": (["gAMA 45455", "IHDR"], False),
}


@pytest.mark.parametrize("name", list(ORDER_CASES))
def test_png_ihdr_comes_first_and_once(tmp_path, name):
    tokens, native_reads = ORDER_CASES[name]
    path = tmp_path / f"{name}.png"
    path.write_bytes(png_with_chunks(2, 8, 0, False, tokens))
    if tokens[0].endswith("!crc"):  # PIL raises on a bad CRC, and so does "pil"
        with pytest.raises(OSError, match="corrupt or truncated"):
            imageio.decode(path, "pil")
    else:
        with Image.open(path) as img:
            np.testing.assert_array_equal(imageio.decode(path, "pil"), np.asarray(img.convert("RGB")))
    if native_reads:
        np.testing.assert_array_equal(imageio.decode(path, "native"), native_u8(path, (32, 32)))
        return
    with pytest.raises(OSError, match="not decodable"):
        native_u8(path, (32, 32))
    with pytest.raises(OSError, match=f"{name}.png is corrupt or truncated"):
        imageio.decode(path, "native")


# ------------------------------------------- the zlib stream's end, long palettes

def _png_parts(png: bytes) -> tuple[bytes, bytes, bytes]:
    """A one-IDAT PNG -> (what precedes the IDAT chunk, its zlib stream, IEND)."""
    i = png.index(b"IDAT") - 4
    n = struct.unpack(">I", png[i:i + 4])[0]
    return png[:i], png[i + 8:i + 8 + n], png[i + 12 + n:]


def _stored_stream(raw: bytes, pad: int) -> bytes:
    """`raw` as a zlib stream of stored blocks: `pad` empty ones, then one
    final block of the data, so that every byte's offset is known."""
    return (b"\x78\x01" + b"\x00\x00\x00\xff\xff" * pad + b"\x01" + struct.pack("<HH", len(raw), len(raw) ^ 0xFFFF)
            + raw + struct.pack(">I", zlib.adler32(raw)))


def _spoil(stream: bytes) -> bytes:  # a wrong Adler-32
    return stream[:-4] + bytes(b ^ 0x55 for b in stream[-4:])


def _more(raw: bytes, extra: bytes = bytes(100)) -> bytes:  # a stream that goes on past the image
    return zlib.compress(raw + extra, 6)


def _more_then_junk(raw: bytes) -> bytes:
    z = zlib.compressobj(6)
    return z.compress(raw + bytes(50)) + z.flush(zlib.Z_SYNC_FLUSH) + b"\xff" * 5


# name -> (colour type, bit depth, h, w, the IDAT payloads from the image's
# filtered rows). libpng and PIL stop at the image's last byte; the call that
# produces it reads on in its input window (libpng's 8192-byte pieces of each
# IDAT chunk, PIL's 65536) until the stream needs output or input, and fails
# on an error met there, a bad Adler-32 included. libpng then reads on to the
# stream's end, taking an error as benign but failing where the IDAT chunks
# run out; PIL reads no more. The stored streams put the Adler-32 across
# libpng's first window edge (8192), or just inside it.
STREAM_CASES = {
    "adler_bad": (2, 8, 32, 32, lambda raw: [_spoil(zlib.compress(raw))]),
    "adler_bad_own_idat": (2, 8, 32, 32, lambda raw: [_spoil(zlib.compress(raw))[:-4],
                                                      _spoil(zlib.compress(raw))[-4:]]),
    "adler_bad_split": (0, 16, 32, 32, lambda raw: [_spoil(zlib.compress(raw))[:-2],
                                                    _spoil(zlib.compress(raw))[-2:]]),
    "adler_bad_more_data": (2, 16, 32, 32, lambda raw: [_spoil(_more(raw))]),
    "junk_after_more_data": (6, 8, 32, 32, lambda raw: [_more_then_junk(raw)]),
    "adler_missing": (2, 8, 32, 32, lambda raw: [zlib.compress(raw)[:-4]]),
    "adler_half": (0, 8, 32, 32, lambda raw: [zlib.compress(raw)[:-2]]),
    "bytes_after_stream": (2, 8, 32, 32, lambda raw: [zlib.compress(raw) + b"junk"]),
    "idat_after_stream": (2, 16, 32, 32, lambda raw: [zlib.compress(raw), b"junk"]),
    "stream_short": (2, 8, 32, 32, lambda raw: [zlib.compress(raw[:-10])]),
    "adler_bad_past_window": (0, 8, 64, 100, lambda raw: [_spoil(_stored_stream(raw, 344))]),
    "adler_bad_in_window": (0, 8, 64, 98, lambda raw: [_spoil(_stored_stream(raw, 369))]),
    "adler_good_past_window": (0, 8, 64, 100, lambda raw: [_stored_stream(raw, 344)]),
}


def _stream_case(name: str) -> tuple[bytes, tuple[int, int]]:
    color, depth, h, w, make = STREAM_CASES[name]
    head, stream, tail = _png_parts(png_case(color, depth, 0, False, h, w))
    return head + b"".join(_chunk(b"IDAT", part) for part in make(zlib.decompress(stream))) + tail, (h, w)


def _same_or_both_raise(got, want, path: Path):
    """`got()` (the port's decode) equals `want()` (the reference's), or both raise."""
    try:
        ref = want()
    except (OSError, SyntaxError):
        with pytest.raises(OSError, match=f"{path.name} is corrupt or truncated"):
            got()
        return
    np.testing.assert_array_equal(got(), ref)


def _pil_rgb_of(path: Path) -> np.ndarray:
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_png_zlib_stream_end_as_each_reader(tmp_path, name):
    """The image data's zlib stream past the image's last byte: "native"
    fails where libpng (the native loader) does and reads what it reads,
    and so does the batch loader; "pil" does as PIL does."""
    data, hw = _stream_case(name)
    path = tmp_path / f"{name}.png"
    path.write_bytes(data)
    if name.endswith("_window"):
        assert len(data) > 8192 and data.count(b"IDAT") == 1
    _same_or_both_raise(lambda: imageio.decode(path, "native"), lambda: native_u8(path, hw), path)
    _same_or_both_raise(lambda: imageio.load_batch([path], hw, n_threads=1),
                        lambda: imageloader_lib.load_batch([str(path)], hw, n_threads=1), path)
    _same_or_both_raise(lambda: imageio.decode(path, "pil"), lambda: _pil_rgb_of(path), path)


# (bit depth, palette entries, tRNS entries): libpng keeps 2^depth entries of
# a longer palette (png_handle_PLTE), and a tRNS longer than what it kept is
# ignored; PIL keeps them all and drops alpha
PALETTE_CASES = [(1, 4, 3), (1, 4, 2), (1, 256, 2), (2, 6, 5), (2, 7, 4), (2, 200, 150), (4, 20, 17),
                 (4, 256, 16), (4, 256, 200), (8, 256, 256)]


@pytest.mark.parametrize("depth,entries,alphas", PALETTE_CASES,
                         ids=[f"d{d}-plte{e}-trns{a}" for d, e, a in PALETTE_CASES])
def test_png_long_palette_native_equals_the_native_loader(tmp_path, depth, entries, alphas):
    rng = np.random.default_rng(depth * 1000 + entries + alphas)
    samples = rng.integers(0, 1 << depth, (32, 32, 1))
    trns = bytes(rng.choice([0, 255, *rng.integers(1, 255, 6)], alphas).astype(np.uint8))
    path = tmp_path / "p.png"
    path.write_bytes(encode_png(samples, 3, depth, 0, rng.integers(0, 256, (entries, 3)), trns, seed=depth))
    np.testing.assert_array_equal(imageio.decode(path, "native"), native_u8(path, (32, 32)))
    np.testing.assert_allclose(imageio.load_batch([path], (32, 32), n_threads=1),
                               imageloader_lib.load_batch([str(path)], (32, 32), n_threads=1), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(imageio.decode(path, "pil"), _pil_rgb_of(path))


def cv2_jpeg_440(pixels, progressive: bool, quality: int = 90) -> bytes:
    """h1v2 (4:4:0) JPEG bytes from cv2's libjpeg, which PIL cannot write."""
    flags = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(pixels[..., ::-1]), flags)
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("hw", [(45, 37), (64, 64), (17, 33)])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_jpeg_440_equals_pil_and_the_native_loader(tmp_path, progressive, hw):
    data = cv2_jpeg_440(smooth(*hw, seed=hw[0] + hw[1]), progressive)
    sof = data.index(b"\xff\xc2" if progressive else b"\xff\xc0")
    assert data[sof + 11] == 0x12 and data[sof + 14] == data[sof + 17] == 0x11  # Y h1v2, Cb and Cr h1v1
    path = tmp_path / "440.jpg"
    path.write_bytes(data)
    got = imageio.decode(path)
    np.testing.assert_array_equal(got, pil_rgb(data))
    np.testing.assert_array_equal(got, native_u8(path, hw))


# ------------------------------------------------------------ batch loader

def _mixed_files(root: Path) -> list[str]:
    """JPEGs of several sizes, an RGBA PNG and a 16-bit one."""
    paths = []
    for k, hw in enumerate([(30, 28), (32, 32), (45, 20)]):
        p = root / f"j{k}.jpg"
        p.write_bytes(pil_jpeg(smooth(*hw, seed=k), quality=90))
        paths.append(str(p))
    (root / "rgba.png").write_bytes(png_case(6, 8, 0, False, 32, 32))
    (root / "grey16.png").write_bytes(png_case(0, 16, 0, False, 40, 36))
    (root / "rgba16.png").write_bytes(png_case(6, 16, 1, False, 24, 30))
    return paths + [str(root / n) for n in ("rgba.png", "grey16.png", "rgba16.png")]


@pytest.mark.parametrize("warp", ["none", "resize", "affine"])
def test_load_batch_equals_the_native_loader(tmp_path, warp):
    paths = _mixed_files(tmp_path)
    n = len(paths)
    flips = np.arange(n) % 2 == 0
    mats = None
    if warp == "affine":  # an all-zero row: that item is resized instead
        mats = np.asarray([[0.8, 0.1, 2.0, -0.05, 0.9, 1.0], [0] * 6, [1.1, -0.2, -3.5, 0.2, 1.1, -2.0]] * 2,
                          np.float32)
    hw = (32, 32) if warp == "none" else (24, 28)
    if warp == "none":
        paths = [p for p in paths if p.endswith(("j1.jpg", "rgba.png"))]
        flips = flips[: len(paths)]
    want = imageloader_lib.load_batch(paths, hw, mats=mats, flips=flips, n_threads=3)
    got = imageio.load_batch(paths, hw, mats=mats, flips=flips, n_threads=3)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_facerec_load_batch_reads_alpha_and_16_bit_png_as_the_native_loader(tmp_path):
    """The facerec batch path on an RGBA and a 16-bit PNG: the native
    loader composites alpha onto black in linear light and takes 16-bit
    samples as linear, where PIL drops alpha and cuts or clips 16 bits (up to
    238 of 255 apart). The batch loader follows the native loader."""
    paths = [str(tmp_path / n) for n in ("rgba.png", "grey16.png")]
    Path(paths[0]).write_bytes(png_case(6, 8, 0, False, 16, 16))
    Path(paths[1]).write_bytes(png_case(0, 16, 0, False, 16, 16))
    want = imageloader_lib.load_batch(paths, (16, 16), n_threads=2)
    np.testing.assert_allclose(tds.load_batch(paths, (16, 16), n_threads=2), want, rtol=0, atol=1e-6)


def test_load_batch_errors_name_the_item(tmp_path):
    paths = _mixed_files(tmp_path)[:2]
    with pytest.raises(OSError, match="missing.jpg is not found"):
        imageio.load_batch([paths[0], str(tmp_path / "missing.jpg")], (8, 8))
    with pytest.raises(ValueError, match="j0.jpg has a singular affine"):
        imageio.load_batch(paths[:1], (8, 8), mats=np.asarray([[1, 2, 0, 2, 4, 0]], np.float32))


# ----------------------------------------------------------------- encoder

@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("hw", [(1, 1), (17, 9), (33, 31), (112, 112)])
def test_jpeg_encoder_writes_pils_bytes(quality, hw):
    """Bytes equal to PIL's `save(f, quality=q)` (its libjpeg-turbo):
    smooth and noise images, every edge case of 4:2:0 padding."""
    for px in (smooth(*hw, seed=quality), np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), np.uint8)):
        assert imageio.encode_jpeg(px, quality) == pil_jpeg(px, quality=quality)


def test_save_image_writes_the_jax_packages_file(tmp_path):
    img = np.random.default_rng(3).uniform(-1.1, 1.1, (40, 52, 3)).astype(np.float32)
    jax_save_image(img, tmp_path / "j.jpg")
    save_image(img, tmp_path / "t" / "t.jpg")
    assert (tmp_path / "t" / "t.jpg").read_bytes() == (tmp_path / "j.jpg").read_bytes()
    save_image(img, tmp_path / "t.png")
    np.testing.assert_array_equal(read_rgb8(tmp_path / "t.png"), to_uint8(img))
    np.testing.assert_array_equal(load_image(tmp_path / "j.jpg"), jax_load_image(tmp_path / "j.jpg"))
    with pytest.raises(ValueError, match="t.gif"):
        save_image(img, tmp_path / "t.gif")


# ------------------------------------------------------------------ errors

def test_unsupported_and_broken_jpegs_raise_naming_the_file(tmp_path):
    px = smooth(40, 36)
    good = pil_jpeg(px, quality=90)
    buf = io.BytesIO()
    Image.fromarray(px).convert("CMYK").save(buf, "JPEG")
    sof = good.index(b"\xff\xc0")
    cases = {
        "cmyk.jpg": (buf.getvalue(), "does not implement"),
        "arithmetic.jpg": (good[:sof] + b"\xff\xc9" + good[sof + 2:], "does not implement"),  # SOF9
        "truncated.jpg": (good[: len(good) // 2], "corrupt or truncated"),
        "no_eoi.jpg": (good[:-2], "corrupt or truncated"),
        "not_an_image.jpg": (b"GIF89a" + good, "neither a PNG nor a JPEG"),
    }
    for name, (data, why) in cases.items():
        (tmp_path / name).write_bytes(data)
        with pytest.raises(OSError, match=f"{name} .*{why}"):
            imageio.decode(tmp_path / name)
        with pytest.raises(OSError, match=f"{name} .*{why}"):
            imageio.load_batch([str(tmp_path / name)], (8, 8))


def test_a_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "fresh")
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    with pytest.raises(RuntimeError, match="nonexistent"):
        build.build(("imageio",))
    assert not (tmp_path / "fresh").exists() or not list((tmp_path / "fresh").glob("*.so"))


def test_decodes_with_pil_blocked(tmp_path):
    """The port reaches no PIL: a fresh interpreter with PIL blocked reads
    JPEG and PNG and writes JPEG."""
    px = smooth(21, 19)
    (tmp_path / "a.jpg").write_bytes(pil_jpeg(px, quality=95))
    np.save(tmp_path / "want.npy", pil_rgb((tmp_path / "a.jpg").read_bytes()))
    code = (
        "import sys; sys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "from fairdiff_torch.io.images import read_rgb8, write_image\n"
        f"d = r'{tmp_path}'\n"
        "px = read_rgb8(d + '/a.jpg')\n"
        "assert (px == np.load(d + '/want.npy')).all()\n"
        "write_image(px, d + '/b.png'); write_image(px, d + '/c.jpg')\n"
        "assert (read_rgb8(d + '/b.png') == px).all()\n"
        "assert 'PIL' not in [m.split('.')[0] for m in sys.modules if sys.modules[m] is not None]\n"
    )
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)
    assert (tmp_path / "c.jpg").read_bytes() == pil_jpeg(pil_rgb((tmp_path / "a.jpg").read_bytes()), quality=95)


if __name__ == "__main__":
    FIXTURES.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURES, **make_fixtures())
    print(f"wrote {FIXTURES} ({FIXTURES.stat().st_size} bytes)")
