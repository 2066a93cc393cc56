"""Render training-metric curves from metrics.jsonl as PNG panels
(counterpart of fairdiff/tools/plot_curves.py, without matplotlib).

The reference monitors finetuning through wandb line panels (train_DAL,
train_gender_gap, val_gender_gap); this CLI renders the same panels from
`<output_dir>/metrics.jsonl`. `--runs` takes a comma-separated list of
`label=metrics.jsonl` to plot runs against each other, and `--csv` a
comma-separated list of `label=path.csv` (wandb export format: a `Step`
column plus one value column) to overlay curves exported from a reference
wandb run (on the first key's panel only).

Each panel is drawn in numpy and written with the port's PNG writer
(`io.images.write_png`; the card's machine has no matplotlib): a 768x480
frame, grid lines at round ticks with their values, one line per series
in the JAX tool's colours (2 px), the raw series faint under the EMA when
`--smooth` is set, a CSV overlay dashed. The data behind every panel goes
to `<key>.csv` beside it, as in the JAX tool.

  python -m fairdiff_torch.tools.plot_curves --runs ours=outputs/exp1/metrics.jsonl \\
      --csv reference=ref_train_gender_gap.csv --keys gender_gap \\
      --save_dir outputs/exp1/curves
"""

from __future__ import annotations

import csv as csv_lib
import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from fairdiff_torch.io.images import write_png
from fairdiff_torch.utils import config as cfglib

# wandb-panel parity: metric keys plotted when --keys auto (the reference
# panels, exp-1 README "Below, we present logs from several example runs")
AUTO_KEYS = [
    "train_loss_fair",      # train_DAL
    "train_loss_face",
    "train_loss",
    "gender_gap",           # train_gender_gap
    "gender_gap_abs",
    "race_gap",
    "gender_race_gap",
    "age_gap",
    "eval_gender_gap",      # val_gender_gap
    "eval_ema_gender_gap",
    "eval_race_gap",
    "eval_ema_race_gap",
    "grad_norm",
    "face_rate",
]

# fixed categorical hue order (never cycled; >6 runs fold to "other" gray)
SERIES_COLORS = [
    "#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4", "#008300",
]
OTHER_COLOR = "#8a8a85"
GRID_COLOR = "#e6e4df"
TEXT_COLOR = "#34322d"

WIDTH, HEIGHT = 768, 480  # the JAX tool's 6.4 x 4.0 in at 120 dpi
LEFT, RIGHT, TOP, BOTTOM = 72, 16, 16, 40  # the plot area's margins, px
RAW_ALPHA = 0.3  # the unsmoothed series under the EMA


@dataclass
class PlotConfig:
    runs: str = ""        # comma-separated label=metrics.jsonl
    csv: str = ""         # comma-separated label=wandb_export.csv
    keys: str = "auto"    # comma list or "auto"
    save_dir: str = "outputs/curves"
    smooth: float = 0.0   # EMA factor (wandb-style), 0=off
    metrics_jsonl: str = ""  # shorthand for one unlabeled run


def _parse_labeled(spec: str, default_prefix: str) -> list[tuple[str, Path]]:
    out = []
    for i, item in enumerate(s for s in spec.split(",") if s.strip()):
        label, _, path = item.strip().rpartition("=")
        out.append((label or f"{default_prefix}{i}", Path(path)))
    return out


def load_jsonl_series(path: Path) -> dict[str, tuple[list[int], list[float]]]:
    """{metric: (steps, values)} from a metrics.jsonl file."""
    series: dict[str, tuple[list[int], list[float]]] = {}
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:  # torn tail line of a live run
                continue
            step = int(rec.get("step", len(series)))
            for k, v in rec.items():
                if k in ("step", "time") or not isinstance(v, (int, float)):
                    continue
                s = series.setdefault(k, ([], []))
                s[0].append(step)
                s[1].append(float(v))
    return series


def load_csv_series(path: Path) -> tuple[list[int], list[float]]:
    """wandb CSV export: a Step column + the first numeric value column."""
    steps, vals = [], []
    with open(path) as f:
        reader = csv_lib.DictReader(f)
        step_col = next(
            (c for c in reader.fieldnames or [] if c.lower() == "step"), None
        )
        for row in reader:
            val = None
            for c, raw in row.items():
                if c == step_col or raw in (None, ""):
                    continue
                try:
                    val = float(raw)
                    break
                except ValueError:
                    continue
            if val is None:
                continue
            steps.append(int(float(row[step_col])) if step_col else len(steps))
            vals.append(val)
    return steps, vals


def ema_smooth(values: list[float], factor: float) -> list[float]:
    """wandb's exponential smoothing (factor in [0,1), 0 = identity)."""
    if not factor:
        return values
    out, acc = [], None
    for v in values:
        acc = v if acc is None else acc * factor + v * (1.0 - factor)
        out.append(acc)
    return out


# -- drawing -----------------------------------------------------------------

# 3x5 digits and signs for tick labels, drawn at 2x: one row a string
_GLYPHS = {
    "0": ("111", "101", "101", "101", "111"), "1": ("010", "110", "010", "010", "111"),
    "2": ("111", "001", "111", "100", "111"), "3": ("111", "001", "111", "001", "111"),
    "4": ("101", "101", "111", "001", "001"), "5": ("111", "100", "111", "001", "111"),
    "6": ("111", "100", "111", "101", "111"), "7": ("111", "001", "010", "010", "010"),
    "8": ("111", "101", "111", "101", "111"), "9": ("111", "101", "111", "001", "111"),
    ".": ("000", "000", "000", "000", "010"), "-": ("000", "000", "111", "000", "000"),
    "e": ("000", "111", "111", "100", "111"), "+": ("000", "010", "111", "010", "000"),
}
_SCALE = 2


def _rgb(hex_color: str) -> np.ndarray:
    return np.array([int(hex_color[i:i + 2], 16) for i in (1, 3, 5)], np.float64)


def nice_ticks(lo: float, hi: float, n: int = 5) -> list[float]:
    """Round tick values covering [lo, hi] at a 1, 2 or 5 x 10^k step."""
    if hi <= lo:
        return [lo]
    raw = (hi - lo) / n
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 5, 10) if m * mag >= raw)
    first = math.ceil(lo / step - 1e-9) * step
    return [first + i * step for i in range(int((hi - first) / step + 1e-9) + 1)]


def _label(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1e5 or abs(v) < 1e-3:
        return f"{v:.0e}".replace("e+0", "e").replace("e-0", "e-")
    return f"{v:.4g}"


class Panel:
    """A WIDTH x HEIGHT RGB canvas with a data -> pixel transform over the
    x and y ranges of the series it is made for."""

    def __init__(self, xs: list[float], ys: list[float]):
        x0, x1 = min(xs), max(xs)
        y0, y1 = min(ys), max(ys)
        pad = (y1 - y0) * 0.05 or max(abs(y0) * 0.05, 1e-3)
        self.x_range = (x0, x1 if x1 > x0 else x0 + 1)
        self.y_range = (y0 - pad, y1 + pad)
        self.pixels = np.full((HEIGHT, WIDTH, 3), 255.0)

    def to_px(self, x: float, y: float) -> tuple[float, float]:
        """(column, row) of a data point."""
        (x0, x1), (y0, y1) = self.x_range, self.y_range
        col = LEFT + (x - x0) / (x1 - x0) * (WIDTH - LEFT - RIGHT - 1)
        row = TOP + (y1 - y) / (y1 - y0) * (HEIGHT - TOP - BOTTOM - 1)
        return col, row

    def _stamp(self, cols: np.ndarray, rows: np.ndarray, color: np.ndarray, alpha: float, width: int) -> None:
        for dc in range(width):
            for dr in range(width):
                c = np.clip(np.round(cols).astype(int) + dc - width // 2, 0, WIDTH - 1)
                r = np.clip(np.round(rows).astype(int) + dr - width // 2, 0, HEIGHT - 1)
                self.pixels[r, c] = (1 - alpha) * self.pixels[r, c] + alpha * color

    def line(self, xs, ys, color: str, alpha: float = 1.0, width: int = 2, dashed: bool = False) -> None:
        """The polyline through the points, sampled one pixel apart."""
        pts = np.array([self.to_px(x, y) for x, y in zip(xs, ys)])
        rgb = _rgb(color)
        if len(pts) == 0:
            return
        if len(pts) == 1:
            self._stamp(pts[:1, 0], pts[:1, 1], rgb, alpha, width + 1)
            return
        for (c0, r0), (c1, r1) in zip(pts[:-1], pts[1:]):
            n = int(max(abs(c1 - c0), abs(r1 - r0))) + 1
            t = np.linspace(0.0, 1.0, n + 1)
            if dashed:  # 6 px on, 4 px off
                t = t[(np.arange(len(t)) % 10) < 6]
            self._stamp(c0 + t * (c1 - c0), r0 + t * (r1 - r0), rgb, alpha, width)

    def text(self, s: str, col: int, row: int, color: str, anchor: str = "right") -> None:
        """Tick-label text (digits, '.', '-', '+', 'e'), 2x the 3x5 glyphs;
        anchored at its right end (y labels) or its centre (x labels)."""
        w = len(s) * 4 * _SCALE
        start = col - w if anchor == "right" else col - w // 2
        rgb = _rgb(color)
        for i, ch in enumerate(s):
            for gr, bits in enumerate(_GLYPHS.get(ch, ("000",) * 5)):
                for gc, bit in enumerate(bits):
                    if bit == "1":
                        r, c = row + gr * _SCALE, start + i * 4 * _SCALE + gc * _SCALE
                        if 0 <= r < HEIGHT - _SCALE and 0 <= c < WIDTH - _SCALE:
                            self.pixels[r:r + _SCALE, c:c + _SCALE] = rgb

    def axes(self) -> None:
        """Grid lines and labels at round ticks, then the frame."""
        grid, ink = _rgb(GRID_COLOR), _rgb(TEXT_COLOR)
        bottom, right = HEIGHT - BOTTOM - 1, WIDTH - RIGHT - 1
        for v in nice_ticks(*self.y_range):
            row = int(round(self.to_px(self.x_range[0], v)[1]))
            if TOP <= row <= bottom:
                self.pixels[row, LEFT:right + 1] = grid
                self.text(_label(v), LEFT - 6, row - 5, TEXT_COLOR)
        for v in nice_ticks(*self.x_range):
            col = int(round(self.to_px(v, self.y_range[0])[0]))
            if LEFT <= col <= right:
                self.pixels[TOP:bottom + 1, col] = grid
                self.pixels[bottom + 1:bottom + 5, col] = ink
                self.text(_label(v), col, bottom + 8, TEXT_COLOR, anchor="center")
        self.pixels[TOP, LEFT:right + 1] = self.pixels[bottom, LEFT:right + 1] = grid
        self.pixels[TOP:bottom + 1, LEFT] = self.pixels[TOP:bottom + 1, right] = ink

    def png(self, path: Path) -> None:
        write_png(np.clip(np.round(self.pixels), 0, 255).astype(np.uint8), path)


def _color(i: int) -> str:
    return SERIES_COLORS[i] if i < len(SERIES_COLORS) else OTHER_COLOR


def render_panel(series: list[tuple[list[float], list[float], bool]], smooth: float) -> Panel:
    """One panel of `series` ((steps, values, dashed) in plotting order):
    grid and ticks, then each series' raw values faint under its EMA (when
    `smooth`), in the colour of its place."""
    smoothed = [(xs, ema_smooth(ys, smooth), dashed) for xs, ys, dashed in series]
    xs_all = [x for xs, _, _ in series for x in xs] or [0.0]
    ys_all = [y for _, ys, _ in series for y in ys] + [y for _, ys, _ in smoothed for y in ys] or [0.0]
    panel = Panel(xs_all, ys_all)
    panel.axes()
    for i, (xs, ys, dashed) in enumerate(series):
        if smooth:
            panel.line(xs, ys, _color(i), alpha=RAW_ALPHA, dashed=dashed)
    for i, (xs, ys, dashed) in enumerate(smoothed):
        panel.line(xs, ys, _color(i), dashed=dashed)
    return panel


def main(cfg: PlotConfig) -> list[Path]:
    runs = _parse_labeled(cfg.runs, "run")
    if cfg.metrics_jsonl:
        runs.insert(0, ("run", Path(cfg.metrics_jsonl)))
    overlays = _parse_labeled(cfg.csv, "csv")
    if not runs and not overlays:
        raise SystemExit("pass --metrics_jsonl, --runs label=path, or --csv")

    data = {label: load_jsonl_series(p) for label, p in runs}
    keys = (
        [k for k in AUTO_KEYS if any(k in s for s in data.values())]
        if cfg.keys == "auto"
        else [k.strip() for k in cfg.keys.split(",") if k.strip()]
    )
    if not keys and overlays:
        # csv-only invocation: one panel named after the first overlay
        keys = [overlays[0][0]]

    out_dir = Path(cfg.save_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written: list[Path] = []
    for key in keys:
        series: list[tuple[list[float], list[float], bool]] = []
        rows: list[tuple[str, int, float]] = []
        for label, s in data.items():
            if key not in s:
                continue
            steps, vals = s[key]
            series.append((steps, vals, False))
            rows += [(label, st, v) for st, v in zip(steps, vals)]
        # each CSV overlay is a single exported curve: it attaches to the
        # FIRST requested key only (put the key it belongs to first)
        for label, p in overlays:
            if key != keys[0]:
                continue
            steps, vals = load_csv_series(p)
            series.append((steps, vals, True))
            rows += [(label, st, v) for st, v in zip(steps, vals)]
        if not series:
            continue
        png = out_dir / f"{key}.png"
        render_panel(series, cfg.smooth).png(png)
        # data behind every panel stays machine-readable next to it
        with open(out_dir / f"{key}.csv", "w", newline="") as f:
            w = csv_lib.writer(f)
            w.writerow(["run", "step", key])
            w.writerows(rows)
        written.append(png)
    print(f"[plot_curves] wrote {len(written)} panel(s) -> {out_dir}")
    return written


if __name__ == "__main__":
    main(cfglib.cli_parse(PlotConfig))
