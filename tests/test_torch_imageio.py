"""fairdiff_torch's image codec (`csrc/imageio.cpp` through `io.imageio`)
against PIL, which the JAX package's `load_image`/`save_image` use, and
against the JAX package's native loader (fairdiff/native/imageloader.cpp:
libjpeg and libpng's simplified API), on the CPU.

Every comparison is exact unless it says otherwise: JPEG pixels equal in
u8 to both readers, PNG pixels equal to PIL (the "pil" convention) or to
libpng (the "native" one), the batch loader equal to the native loader in
fp32, and the encoder's bytes equal to PIL's.

The card's machine has no PIL, so `chip_smoke.py` holds the library to
`fairdiff_torch/testdata/imageio_fixtures.npz`: PIL-written JPEGs, their
PIL-decoded pixels and PIL's quality-95 bytes for the encoder, written by
`make_fixtures` below (`python tests/test_torch_imageio.py` rewrites it).
"""

import io
import struct
import subprocess
import sys
import zlib
from pathlib import Path

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


def make_fixtures() -> dict[str, np.ndarray]:
    out = {}
    for k, (name, (h, w, mode, kw)) in enumerate(FIXTURE_CASES.items()):
        px = smooth(h, w, 1 if mode == "L" else 3, seed=k)
        data = pil_jpeg(px[..., 0] if mode == "L" else px, **kw)
        out[f"{name}.jpg"] = np.frombuffer(data, np.uint8)
        out[f"{name}.pixels"] = pil_rgb(data)
    out["encode.source"] = smooth(*ENCODE_HW, seed=99)
    out["encode.q95"] = np.frombuffer(pil_jpeg(out["encode.source"], quality=95), np.uint8)
    return out


def test_fixtures_are_the_seeded_scripts_and_decode_exactly():
    stored = dict(np.load(FIXTURES))
    fresh = make_fixtures()
    assert stored.keys() == fresh.keys()
    for k in fresh:
        np.testing.assert_array_equal(stored[k], fresh[k], err_msg=k)
    for name in FIXTURE_CASES:
        np.testing.assert_array_equal(imageio.decode(stored[f"{name}.jpg"].tobytes()), stored[f"{name}.pixels"])
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
