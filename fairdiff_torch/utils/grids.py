"""Annotated image grids, drawn in numpy (counterpart of
fairdiff/utils/grids.py, which draws with PIL).

The tile order, border and stripe colours, face-box outline, confidence bars
and canvas size are the JAX package's; the lane index is drawn with a small
built-in digit bitmap in place of PIL's default font. The file is written in
the format its suffix names (`io.images.write_image`): a `.jpg` at the JAX
package's default quality, as it writes them, or a `.png`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from fairdiff_torch.io.images import to_uint8, write_image

GRID_QUALITY = 70  # fairdiff/utils/grids.py's JPEG quality

CLASS_COLORS = [
    (239, 65, 54),  # red
    (28, 117, 188),  # blue
    (34, 177, 76),  # green
    (255, 127, 39),  # orange
    (163, 73, 164),  # purple
    (255, 201, 14),  # yellow
]
# per-attribute palettes (gender red/blue; race limegreen/black/brown/orange;
# age yellow/purple)
ATTR_PALETTES = {
    "gender": [(239, 65, 54), (28, 117, 188)],
    "race": [(50, 205, 50), (20, 20, 20), (150, 75, 0), (255, 127, 39)],
    "age": [(255, 201, 14), (163, 73, 164)],
}
_NO_FACE = (255, 255, 255)
_WHITE = (255, 255, 255)

# 3x5 digits, one string of rows each
_DIGITS = {
    "0": "111101101101111", "1": "010110010010111", "2": "111001111100111",
    "3": "111001111001111", "4": "101101111001001", "5": "111100111001111",
    "6": "111100111101111", "7": "111001001001001", "8": "111101111101111",
    "9": "111101111001111",
}


def _fill(canvas: np.ndarray, x0: int, y0: int, x1: int, y1: int, color) -> None:
    """PIL's `rectangle([x0, y0, x1, y1], fill=color)`: corners inclusive."""
    canvas[max(y0, 0): y1 + 1, max(x0, 0): x1 + 1] = color


def _outline(img: np.ndarray, box, color, width: int) -> None:
    """PIL's `rectangle(box, outline=color, width=width)`: `width` rings
    inward from the box's edge (coordinates truncated as PIL does)."""
    x0, y0, x1, y1 = (int(v) for v in box)
    for i in range(width):
        a, b, c, d = x0 + i, y0 + i, x1 - i, y1 - i
        if c < a or d < b:
            break
        _fill(img, a, b, c, b, color)
        _fill(img, a, d, c, d, color)
        _fill(img, a, b, a, d, color)
        _fill(img, c, b, c, d, color)


def _text(canvas: np.ndarray, x: int, y: int, digits: str, color, scale: int) -> None:
    """Digits at (x, y) from the 3x5 bitmap, `scale` pixels a dot."""
    for n, ch in enumerate(digits):
        glyph = np.array([int(b) for b in _DIGITS[ch]], bool).reshape(5, 3)
        dots = np.kron(glyph, np.ones((scale, scale), bool))
        gx = x + n * 4 * scale
        region = canvas[y: y + dots.shape[0], gx: gx + dots.shape[1]]
        region[dots[: region.shape[0], : region.shape[1]]] = color


def plot_in_grid(
    images: np.ndarray,  # [N, H, W, 3] in [-1, 1]
    save_to: str | Path,
    *,
    face_indicators: Optional[np.ndarray] = None,
    preds: Optional[np.ndarray] = None,  # [N] int, -1 fill
    probs_max: Optional[np.ndarray] = None,  # [N] confidence of pred
    cols: Optional[int] = None,
    border: int = 4,
    bar_height: int = 6,
) -> Path:
    """Single-attribute grid: the no-face block first, then each predicted
    class by ascending confidence; a border in the class colour (black
    without a face), a confidence bar under each tile, the lane index on
    it."""
    n = len(images)
    face_indicators = np.asarray(face_indicators) if face_indicators is not None else np.ones(n, bool)
    preds = np.asarray(preds) if preds is not None else np.zeros(n, int)
    probs_max = np.asarray(probs_max) if probs_max is not None else np.ones(n)

    order = [i for i in range(n) if not face_indicators[i]]
    for cls in sorted(set(int(p) for p in preds if p >= 0)):
        members = [i for i in range(n) if face_indicators[i] and preds[i] == cls]
        order += sorted(members, key=lambda i: probs_max[i])

    imgs = to_uint8(np.asarray(images))
    h, w = imgs.shape[1:3]
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    tile_h = h + 2 * border + bar_height
    tile_w = w + 2 * border
    canvas = np.full((rows * tile_h, cols * tile_w, 3), 255, np.uint8)
    scale = max(1, h // 128)

    for slot, idx in enumerate(order):
        r, c = divmod(slot, cols)
        x0, y0 = c * tile_w, r * tile_h
        color = (
            CLASS_COLORS[int(preds[idx]) % len(CLASS_COLORS)]
            if face_indicators[idx] and preds[idx] >= 0 else (0, 0, 0)
        )
        _fill(canvas, x0, y0, x0 + tile_w - 1, y0 + h + 2 * border - 1, color)
        canvas[y0 + border: y0 + border + h, x0 + border: x0 + border + w] = imgs[idx]
        bar_y = y0 + h + 2 * border
        _fill(canvas, x0, bar_y, x0 + tile_w - 1, bar_y + bar_height - 1, (230, 230, 230))
        if face_indicators[idx]:
            frac = float(np.clip(probs_max[idx], 0, 1))
            _fill(canvas, x0, bar_y, x0 + int(frac * (tile_w - 1)), bar_y + bar_height - 1, color)
        _text(canvas, x0 + border + 2, y0 + border + 2, str(idx), _WHITE, scale)
    return write_image(canvas, save_to, GRID_QUALITY)


def plot_in_grid_multi(
    images: np.ndarray,  # [N, H, W, 3] in [-1, 1]
    save_to: str | Path,
    attrs: dict[str, tuple[np.ndarray, np.ndarray]],  # name -> (preds, conf)
    *,
    face_indicators: Optional[np.ndarray] = None,
    face_bboxes: Optional[np.ndarray] = None,  # [N, 4] xyxy, -1 fill
    cols: Optional[int] = None,
    border: int = 4,
    stripe: int = 10,
    bar_height: int = 5,
) -> Path:
    """Multi-attribute grid (gender x race [x age]): tiles ordered by joint
    predicted class (confidence-descending within a cell, no-face last), the
    outer border coloured by the first attribute, one side stripe per further
    attribute, the face box outlined, one confidence bar per attribute."""
    n = len(images)
    names = list(attrs)
    face_indicators = np.asarray(face_indicators) if face_indicators is not None else np.ones(n, bool)
    preds = {a: np.asarray(attrs[a][0]) for a in names}
    confs = {a: np.asarray(attrs[a][1]) for a in names}

    def sort_key(i):
        if not face_indicators[i] or any(preds[a][i] < 0 for a in names):
            return (1, 0, 0.0)
        return (0, tuple(int(preds[a][i]) for a in names), -float(confs[names[-1]][i]))

    order = sorted(range(n), key=sort_key)

    imgs = to_uint8(np.asarray(images))
    h, w = imgs.shape[1:3]
    n_stripes = len(names) - 1
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    tile_w = w + 2 * border + n_stripes * stripe
    tile_h = h + 2 * border + len(names) * bar_height
    canvas = np.full((rows * tile_h, cols * tile_w, 3), 255, np.uint8)
    scale = max(1, h // 128)

    def color(a, i):
        p = int(preds[a][i])
        if not face_indicators[i] or p < 0:
            return _NO_FACE
        pal = ATTR_PALETTES.get(a, CLASS_COLORS)
        return pal[p % len(pal)]

    for slot, idx in enumerate(order):
        r, c = divmod(slot, cols)
        x0, y0 = c * tile_w, r * tile_h
        for s, a in enumerate(names[1:]):  # attributes 2..k as left stripes
            sx = x0 + s * stripe
            _fill(canvas, sx, y0, sx + stripe - 1, y0 + h + 2 * border - 1, color(a, idx))
        bx = x0 + n_stripes * stripe
        _fill(canvas, bx, y0, bx + w + 2 * border - 1, y0 + h + 2 * border - 1, color(names[0], idx))
        tile = imgs[idx].copy()
        if face_bboxes is not None and face_indicators[idx]:
            bb = np.asarray(face_bboxes[idx]).tolist()
            if bb[2] > bb[0]:
                _outline(tile, bb, (0, 0, 0), 3)
        canvas[y0 + border: y0 + border + h, bx + border: bx + border + w] = tile
        _text(canvas, bx + border + 2, y0 + border + 2, str(idx), _WHITE, scale)
        for s, a in enumerate(names):
            bar_y = y0 + h + 2 * border + s * bar_height
            _fill(canvas, x0, bar_y, x0 + tile_w - 1, bar_y + bar_height - 1, (235, 235, 235))
            if face_indicators[idx] and preds[a][idx] >= 0:
                frac = float(np.clip(confs[a][idx], 0, 1))
                _fill(canvas, x0, bar_y, x0 + int(frac * (tile_w - 1)), bar_y + bar_height - 1, color(a, idx))
    return write_image(canvas, save_to, GRID_QUALITY)
