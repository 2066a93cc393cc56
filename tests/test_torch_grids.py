"""fairdiff_torch.utils.grids (numpy, PNG) against fairdiff.utils.grids
(PIL, JPEG): the same canvas size and tile order, and the border, stripe and
confidence-bar pixels within 16 levels of the JAX grid saved as JPEG at
quality 100 (its chroma subsampling and rounding), sampled inside solid
regions away from the lane index and the face box."""

import numpy as np
import pytest
import torch
from PIL import Image

from fairdiff.utils import grids as jgrids
from fairdiff_torch.utils import grids as tgrids

torch.set_num_threads(1)

N, SIZE, BORDER = 7, 32, 4
LEVELS = 16
# lane i is one solid colour, so a tile's interior names its lane
COLORS = np.array([[30 + 30 * i, 220 - 25 * i, (90 * i) % 256] for i in range(N)], np.float32)
IMAGES = np.broadcast_to(COLORS[:, None, None, :] / 127.5 - 1.0, (N, SIZE, SIZE, 3)).copy()
FACES = np.array([1, 1, 0, 1, 1, 1, 1], bool)
ATTRS = {
    "gender": (np.array([0, 1, 1, 0, -1, 1, 0]), np.array([0.9, 0.8, 0.6, 0.7, -1.0, 0.95, 0.3])),
    "race": (np.array([0, 1, 2, 3, -1, 0, 2]), np.array([0.5, 0.6, 0.7, 0.8, -1.0, 0.9, 0.2])),
}
BBOXES = np.array([[4, 4, 12, 12]] * N, np.float32)


def _read(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB")).astype(int)


def _lane(pixel) -> int:
    """The lane whose colour `pixel` is; -1 for the white of an empty slot."""
    if (pixel >= 250).all():
        return -1
    return int(np.argmin(np.abs(COLORS - pixel).sum(axis=1)))


def _tiles(canvas, tile_w, tile_h, img_x):
    """The lane in each slot, from a pixel of the image away from the index
    text and the face box."""
    cols = canvas.shape[1] // tile_w
    return [_lane(canvas[(s // cols) * tile_h + BORDER + 24, (s % cols) * tile_w + img_x + BORDER + 24])
            for s in range(N)]


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_grid_matches_jax(tmp_path, kind):
    if kind == "single":
        kw = dict(face_indicators=FACES, preds=ATTRS["gender"][0], probs_max=ATTRS["gender"][1])
        jpath = jgrids.plot_in_grid(IMAGES, tmp_path / "j.jpg", quality=100, **kw)
        tpath = tgrids.plot_in_grid(IMAGES, tmp_path / "t.png", **kw)
        stripes, bars, bar_h = 0, 1, 6
        confs = [ATTRS["gender"][1]]
        placed = [i for i in range(N) if i != 4]  # a face lane without a class has no tile here
    else:
        kw = dict(face_indicators=FACES, face_bboxes=BBOXES)
        jpath = jgrids.plot_in_grid_multi(IMAGES, tmp_path / "j.jpg", ATTRS, quality=100, **kw)
        tpath = tgrids.plot_in_grid_multi(IMAGES, tmp_path / "t.png", ATTRS, **kw)
        stripes, bars, bar_h = 1, 2, 5
        confs = [c for _, c in ATTRS.values()]
        placed = list(range(N))  # lanes without a face or a class go last
    assert tpath.suffix == ".png"
    j, t = _read(jpath), _read(tpath)
    assert j.shape == t.shape
    tile_w, tile_h = SIZE + 2 * BORDER + 10 * stripes, SIZE + 2 * BORDER + bars * bar_h
    assert t.shape[:2] == (3 * tile_h, 3 * tile_w)  # ceil(sqrt(7)) = 3 columns, 3 rows
    order = _tiles(t, tile_w, tile_h, 10 * stripes)
    assert order == _tiles(j, tile_w, tile_h, 10 * stripes)
    assert sorted(order) == [-1] * (N - len(placed)) + placed
    samples = []
    for slot in range(len(placed)):
        x0, y0 = (slot % 3) * tile_w, (slot // 3) * tile_h
        bx = x0 + 10 * stripes
        samples += [(y0 + BORDER + SIZE // 2, bx + 1), (y0 + BORDER + SIZE // 2, bx + BORDER + SIZE + 2)]
        samples += [(y0 + BORDER + 20, x0 + 10 * s + 5) for s in range(stripes)]
        for s in range(bars):
            bar_y = y0 + SIZE + 2 * BORDER + s * bar_h + 2
            samples.append((bar_y, x0 + 1))
            # the bar's empty end, where the filled part stops 4 pixels or more before it
            if np.clip(confs[s][order[slot]], 0, 1) * (tile_w - 1) < tile_w - 5:
                samples.append((bar_y, x0 + tile_w - 2))
    for y, x in samples:
        assert np.abs(t[y, x] - j[y, x]).max() <= LEVELS, (y, x, t[y, x], j[y, x])
    # the face box: a black ring 3 wide inside [4, 12] of each face tile
    if kind == "multi":
        y0, bx = BORDER, 10 + BORDER
        assert (t[y0 + 11, bx + 5:bx + 12] == 0).all() and (t[y0 + 7, bx + 4:bx + 7] == 0).all()
        assert (t[y0 + 8, bx + 8] != 0).any()  # inside the ring


def test_lane_index_is_drawn(tmp_path):
    """The index digits are white dots at (border + 2, border + 2) of the
    image; the rest of that corner keeps the image's colour."""
    path = tgrids.plot_in_grid(IMAGES[:1], tmp_path / "one.png")
    t = _read(path)
    corner = t[BORDER + 2:BORDER + 7, BORDER + 2:BORDER + 5]  # the 3x5 glyph of "0"
    white = (corner == 255).all(axis=-1)
    assert white.sum() == 12 and not white[2, 1]  # "0" is a ring
