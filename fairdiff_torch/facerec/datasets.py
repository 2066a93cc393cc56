"""Face-recognition datasets and verification metrics (counterpart of
fairdiff/facerec/datasets.py; opensphere's data layer, SURVEY.md §2.2).

ClassDataset (annotation-file classification training with optional label
noise, opensphere/dataset/class_dataset.py:9-76), PairDataset
(verification pairs, ACC/EER/AUC/TPR@FPR, pair_dataset.py:69-), ItemDataset,
IJBDataset (template 1:1 and 1:N protocols) and the image pipeline
(dataset/utils.py:13-37). Host-side: the input pipeline, not the
differentiable path. No cv2 and no sklearn:

- images are read by `io.images.read_rgb8` (the port's codec, PIL's
  convention) and normalised as `(u8 - 127.5) / 127.5` in fp32;
- `load_batch` is the port's C++ batch loader (`io.imageio.load_batch`,
  the counterpart of fairdiff/native/imageloader.cpp, libpng's convention
  for PNG) on a thread pool: the size-matched fast path, else a bilinear
  warp that maps pixel centres and reads 0 outside the image. `_load_one`
  and `warp_bilinear` are its plain numpy version, which the item path and
  the IJB alignment use;
- the 5-point alignment of the IJB path is that warp with the inverse of
  the forward similarity, as `cv2.warpAffine` does (cv2 snaps coordinates
  to 1/32 pixel; this warp does not);
- the ROC is `roc_curve`, sklearn's result in numpy.
"""

from __future__ import annotations

import dataclasses
import random
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from fairdiff_torch.guidance.geometry import estimate_similarity
from fairdiff_torch.io import imageio
from fairdiff_torch.io.images import read_rgb8 as _read

_HALF = np.float32(127.5)


def _normalize(pixels: np.ndarray) -> np.ndarray:
    return (pixels.astype(np.float32) - _HALF) / _HALF


def _inverse_affine(mat: np.ndarray, name: str) -> np.ndarray:
    """Inverse of a forward [2, 3] affine in fp32 (imageloader.cpp's)."""
    a, b, c, d, e, f = (np.float32(v) for v in np.asarray(mat, np.float32).reshape(6))
    det = a * e - b * d
    if abs(det) < np.float32(1e-12):
        raise ValueError(f"singular affine matrix for {name} (degenerate landmarks?)")
    return np.asarray([e / det, -b / det, (b * f - e * c) / det,
                       -d / det, a / det, (d * c - a * f) / det], np.float32)


def warp_bilinear(pixels: np.ndarray, inv: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """[H, W, 3] uint8 sampled at `inv` (output pixel -> source, [6] fp32)
    with bilinear weights and 0 outside the image -> [h, w, 3] fp32 in
    [0, 255]. The fp32 arithmetic of imageloader.cpp `sample_bilinear`."""
    out_h, out_w = out_hw
    src_h, src_w = pixels.shape[:2]
    x = np.arange(out_w, dtype=np.float32)[None, :]
    y = np.arange(out_h, dtype=np.float32)[:, None]
    sx = inv[0] * x + inv[1] * y + inv[2]
    sy = inv[3] * x + inv[4] * y + inv[5]
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    acc = np.zeros((out_h, out_w, 3), np.float32)
    for dy, wy in ((0, np.float32(1) - fy), (1, fy)):
        yy = y0 + dy
        for dx, wx in ((0, np.float32(1) - fx), (1, fx)):
            xx = x0 + dx
            ok = (yy >= 0) & (yy < src_h) & (xx >= 0) & (xx < src_w)
            p = pixels[np.clip(yy, 0, src_h - 1), np.clip(xx, 0, src_w - 1)].astype(np.float32)
            acc += np.where(ok[..., None], (wy * wx)[..., None] * p, np.float32(0))
    return acc


def _resize_inverse(src_hw: tuple[int, int], out_hw: tuple[int, int]) -> np.ndarray:
    """Output pixel centres onto the source's (cv2.resize INTER_LINEAR's
    coordinates, imageloader.cpp's resize mapping)."""
    sx = np.float32(src_hw[1]) / np.float32(out_hw[1])
    sy = np.float32(src_hw[0]) / np.float32(out_hw[0])
    half = np.float32(0.5)
    return np.asarray([sx, 0, half * sx - half, 0, sy, half * sy - half], np.float32)


def _load_one(path: str, mat: Optional[np.ndarray], flip: bool, out_hw: tuple[int, int]) -> np.ndarray:
    pixels = _read(path)
    if mat is None and pixels.shape[:2] == tuple(out_hw):  # fast path: normalise (and flip)
        out = _normalize(pixels)
    else:
        inv = _inverse_affine(mat, path) if mat is not None else _resize_inverse(pixels.shape[:2], out_hw)
        out = (warp_bilinear(pixels, inv, out_hw) - _HALF) / _HALF
    return out[:, ::-1] if flip else out


def load_batch(
    paths: Sequence[str],
    out_hw: tuple[int, int],
    *,
    mats: Optional[np.ndarray] = None,  # [N, 2, 3] or [N, 6] forward affines; an all-zero row: no warp
    flips: Optional[np.ndarray] = None,  # [N] bool
    n_threads: int = 8,
) -> np.ndarray:
    """-> [N, H, W, 3] fp32 in [-1, 1]: decode, warp or resize, normalise
    and flip each image on `n_threads` threads (fairdiff/native's
    `load_batch`, through the port's C++ loader). Raises OSError naming the
    first unreadable path, and ValueError for a singular affine."""
    return imageio.load_batch(paths, out_hw, mats=mats, flips=flips, n_threads=n_threads)


def image_pipeline(
    info: dict,
    test_mode: bool,
    rng: Optional[random.Random] = None,
) -> np.ndarray:
    """Read -> RGB -> optional 5-pt similarity alignment -> [-1,1] HWC fp32
    -> random horizontal flip in train mode (opensphere/dataset/utils.py:13-37;
    NHWC, not CHW)."""
    path = str(info["path"])
    src = info.get("src_landmark")
    tgz = info.get("tgz_landmark")
    crop_size = info.get("crop_size")
    if not (src is None or tgz is None or crop_size is None):
        m = estimate_similarity(torch.as_tensor(np.asarray(tgz, np.float32)),
                                torch.as_tensor(np.asarray(src, np.float32))).numpy()
        w, h = crop_size  # cv2's dsize order
        image = _load_one(path, m, False, (h, w))
    else:
        image = _normalize(_read(path))
    rng = rng or random
    if not test_mode and rng.random() > 0.5:
        image = image[:, ::-1, :].copy()
    return image


@dataclasses.dataclass
class ClassDataset:
    """name \\t path \\t label annotation file; optional label corruption
    (class_dataset.py label-noise option)."""

    data_dir: str
    ann_path: str
    test_mode: bool = False
    noise_ratio: float = 0.0
    noise_seed: int = 0

    def __post_init__(self):
        items = []
        with open(self.ann_path) as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) < 2:
                    continue
                path, label = parts[0], int(parts[-1])
                items.append((str(Path(self.data_dir) / path), label))
        self.items = items
        self.num_classes = max(l for _, l in items) + 1 if items else 0
        self.labels = np.asarray([l for _, l in items])
        if self.noise_ratio > 0:
            rng = np.random.default_rng(self.noise_seed)
            n_corrupt = int(len(items) * self.noise_ratio)
            idx = rng.choice(len(items), n_corrupt, replace=False)
            self.labels = self.labels.copy()
            self.labels[idx] = rng.integers(0, self.num_classes, n_corrupt)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        img = image_pipeline({"path": self.items[i][0]}, self.test_mode)
        return img, int(self.labels[i])

    def batches(self, batch_size: int, seed: int = 0, drop_last: bool = True,
                image_size: Optional[int] = None, n_threads: int = 8):
        """Restartable shuffled batch iterator (IterLoader semantics,
        opensphere/utils.py:55-79). With `image_size`, whole batches go
        through `load_batch` with the draws of the JAX package's native path
        (the permutation, then `rng.random(n) > 0.5` flips, from one
        `default_rng(seed)`); without it, through `image_pipeline` item by
        item."""
        rng = np.random.default_rng(seed)
        while True:
            order = rng.permutation(len(self))
            for s in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
                idx = order[s: s + batch_size]
                if image_size is not None:
                    flips = None if self.test_mode else rng.random(len(idx)) > 0.5
                    imgs = load_batch([self.items[i][0] for i in idx], (image_size, image_size),
                                      flips=flips, n_threads=n_threads)
                    yield imgs, self.labels[idx]
                else:
                    imgs, labels = zip(*(self[i] for i in idx))
                    yield np.stack(imgs), np.asarray(labels)


@dataclasses.dataclass
class PairDataset:
    """Verification pairs: lines `path1 path2 label`."""

    data_dir: str
    ann_path: str
    metrics_fprs: Sequence[float] = (1e-4, 1e-3)

    def __post_init__(self):
        self.pairs = []
        with open(self.ann_path) as f:
            for line in f:
                p1, p2, label = line.strip().split()[:3]
                self.pairs.append((str(Path(self.data_dir) / p1), str(Path(self.data_dir) / p2), int(label)))

    def __len__(self):
        return len(self.pairs)

    def evaluate(self, feats_by_path: dict) -> list[tuple[str, float]]:
        scores, labels = [], []
        for p1, p2, label in self.pairs:
            scores.append(float(np.dot(feats_by_path[p1], feats_by_path[p2])))
            labels.append(label)
        return verification_metrics(labels, scores, list(self.metrics_fprs))


@dataclasses.dataclass
class ItemDataset:
    """Dataset over pre-built `image_pipeline` info dicts ({"path": ...,
    optional landmarks/crop_size}; opensphere/dataset/item_dataset.py)."""

    data_items: list
    test_mode: bool = True

    def __len__(self):
        return len(self.data_items)

    def __getitem__(self, i):
        return image_pipeline(self.data_items[i], self.test_mode), i


class IJBDataset:
    """IJB-B/C template-based 1:1 verification + 1:N identification
    (opensphere/dataset/ijb_dataset.py:15-266), with the JAX package's
    vectorised segment aggregation.

    Metadata files (IJB distribution format):
      - data_ann: `path x1 y1 ... x5 y5 faceness` per image (5-pt landmarks)
      - tmpl_ann: `path tmpl_id media_id` per image (tid_mid file)
      - gallery/probe_ann: CSV with header, cols `tmpl_id,subj_id,...`
      - pair_ann: `tmpl_id0 tmpl_id1 label` verification pairs

    Template features: each image feature is scaled by its faceness and by
    1/(#images sharing its media within the template), then averaged per
    template and L2-normalised (ref feat2template:158-174).
    """

    def __init__(
        self,
        data_dir: str,
        meta_dir: str,
        data_ann_file: str,
        tmpl_ann_file: str,
        gallery_ann_files: Sequence[str],
        probe_ann_files: Sequence[str],
        pair_ann_file: str,
        src_landmark: Sequence[Sequence[float]],
        test_mode: bool = True,
    ):
        self.data_dir = data_dir
        self.src_landmark = np.asarray(src_landmark, np.float32).reshape(5, 2)
        self.test_mode = test_mode
        meta = Path(meta_dir)

        self.data_items = []
        with open(meta / data_ann_file) as f:
            for line in f:
                terms = line.rstrip().split(" ")
                self.data_items.append({
                    "path": terms[0],
                    "tgz_landmark": np.asarray([float(t) for t in terms[1:-1]], np.float32).reshape(5, 2),
                    "faceness": float(terms[-1]),
                })

        tmpl_ids, media_ids = [], []
        with open(meta / tmpl_ann_file) as f:
            for line in f:
                terms = line.rstrip().split(" ")
                tmpl_ids.append(int(terms[1]))
                media_ids.append(int(terms[2]))
        tmpl_ids = np.asarray(tmpl_ids)
        media_ids = np.asarray(media_ids)
        uniq_tmpl, self._segments = np.unique(tmpl_ids, return_inverse=True)
        self._tmpl_posn = {int(t): i for i, t in enumerate(uniq_tmpl)}
        self.num_templates = len(uniq_tmpl)
        # weight = 1 / (#images with the same (template, media))
        pair_key = tmpl_ids.astype(np.int64) * (media_ids.max() + 1) + media_ids
        _, inv, counts = np.unique(pair_key, return_inverse=True, return_counts=True)
        self._weights = (1.0 / counts[inv]).astype(np.float32)
        self._tmpl_sizes = np.bincount(self._segments, minlength=self.num_templates)

        # 1:N gallery/probe: the first occurrence of each template wins (ref :106-120)
        self.iden_info = {
            "g": self._parse_1n(meta, gallery_ann_files),
            "p": self._parse_1n(meta, probe_ann_files),
        }
        p0, p1, labels = [], [], []
        with open(meta / pair_ann_file) as f:
            for line in f:
                t0, t1, lab = line.rstrip().split(" ")[:3]
                p0.append(self._tmpl_posn[int(t0)])
                p1.append(self._tmpl_posn[int(t1)])
                labels.append(int(lab))
        self.veri_info = {"posn_ids0": np.asarray(p0), "posn_ids1": np.asarray(p1), "labels": np.asarray(labels)}

    def _parse_1n(self, meta: Path, ann_files: Sequence[str]) -> dict:
        seen, posn_ids, subj_ids = set(), [], []
        for ann in ann_files:
            with open(meta / ann) as f:
                for line in list(f)[1:]:
                    terms = line.rstrip().split(",")
                    tmpl_id, subj_id = int(terms[0]), int(terms[1])
                    if tmpl_id in seen:
                        continue
                    seen.add(tmpl_id)
                    posn_ids.append(self._tmpl_posn[tmpl_id])
                    subj_ids.append(subj_id)
        return {"posn_ids": np.asarray(posn_ids), "subj_ids": np.asarray(subj_ids)}

    def __len__(self):
        return len(self.data_items)

    def info(self, idx: int) -> dict:
        item = self.data_items[idx]
        return {
            "path": str(Path(self.data_dir) / item["path"]),
            "src_landmark": self.src_landmark,
            "tgz_landmark": item["tgz_landmark"],
            "crop_size": [112, 112],
        }

    def __getitem__(self, idx):
        return image_pipeline(self.info(idx), self.test_mode), idx

    def feat2template(self, feats: np.ndarray) -> np.ndarray:
        """(n_images, d) -> (n_templates, d) L2-normalised, one segment sum
        (ref :158-174)."""
        faceness = np.asarray([it["faceness"] for it in self.data_items], np.float32)
        weighted = feats * (faceness * self._weights)[:, None]
        tmpl = np.zeros((self.num_templates, feats.shape[1]), np.float32)
        np.add.at(tmpl, self._segments, weighted)
        tmpl /= np.maximum(self._tmpl_sizes, 1)[:, None]
        norms = np.linalg.norm(tmpl, axis=1, keepdims=True)
        return tmpl / np.clip(norms, 1e-12, None)

    def evaluate_11(
        self, tmpl_feats: np.ndarray, fprs: Sequence[float] = tuple(10.0**p for p in range(-6, 0))
    ) -> list[tuple[str, float]]:
        f0 = tmpl_feats[self.veri_info["posn_ids0"]]
        f1 = tmpl_feats[self.veri_info["posn_ids1"]]
        scores = np.einsum("nd,nd->n", f0, f1)
        metrics = verification_metrics(self.veri_info["labels"].tolist(), scores.tolist(), list(fprs))
        return [m for m in metrics if m[0].startswith("TPR")]

    def evaluate_1n(
        self,
        tmpl_feats: np.ndarray,
        topk: Sequence[int] = (1, 5, 10),
        fpirs: Sequence[float] = (1e-2, 1e-1),
    ) -> tuple[list[tuple[str, float]], list[tuple[str, float]]]:
        g, p = self.iden_info["g"], self.iden_info["p"]
        g_feats = tmpl_feats[g["posn_ids"]]
        p_feats = tmpl_feats[p["posn_ids"]]
        n_probe = len(p["subj_ids"])

        scores = p_feats @ g_feats.T
        order = np.argsort(-scores, axis=1)[:, : max(topk)]
        correct = g["subj_ids"][order] == p["subj_ids"][:, None]
        topk_accs = [(f"top{k}", 100.0 * float(np.any(correct[:, :k], axis=1).mean())) for k in topk]

        mask = p["subj_ids"][:, None] == g["subj_ids"][None, :]
        pos_scores = scores[mask]
        neg_scores = np.sort(scores[~mask])[::-1]
        tpirs = []
        for fpir in fpirs:
            k = int(np.ceil(fpir * n_probe))
            th = neg_scores[k - 1]
            tpirs.append((f"TPIR@FPIR={fpir}", 100.0 * float((pos_scores > th).sum()) / n_probe))
        return topk_accs, tpirs

    def evaluate(self, feats: np.ndarray) -> list[tuple[str, float]]:
        tmpl_feats = self.feat2template(np.asarray(feats, np.float32))
        tprs = self.evaluate_11(tmpl_feats)
        topk_accs, tpirs = self.evaluate_1n(tmpl_feats)
        return tprs + topk_accs + tpirs


def roc_curve(labels, scores) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """sklearn.metrics.roc_curve(labels, scores, pos_label=1) in numpy:
    thresholds descending with tied scores collapsed into one point,
    collinear intermediate points dropped, (0, 0) prepended at threshold
    inf -> (fpr, tpr, thresholds)."""
    y = np.asarray(labels) == 1
    s = np.asarray(scores)
    order = np.argsort(s, kind="mergesort")[::-1]
    s, y = s[order], y[order]
    idx = np.r_[np.where(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    thresholds = s[idx]
    if fps.shape[0] > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    return fps / fps[-1], tps / tps[-1], thresholds


def verification_metrics(
    labels: list[int], scores: list[float], fprs: Optional[list[float]] = None
) -> list[tuple[str, float]]:
    """ACC/EER/AUC/TPR@FPR (opensphere/dataset/utils.py:39-61)."""
    from scipy.interpolate import interp1d
    from scipy.optimize import brentq

    labels = list(labels)
    fpr, tpr, _ = roc_curve(labels, scores)
    roc = interp1d(fpr, tpr)
    eer = 100.0 * brentq(lambda x: 1.0 - x - roc(x), 0.0, 1.0)
    auc = 100.0 * float(np.add.reduce(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))  # sklearn's trapezoid
    tnr = 1.0 - fpr
    pos = labels.count(1)
    neg = labels.count(0)
    acc = 100.0 * float(np.max(tpr * pos + tnr * neg)) / len(labels)
    out = [("ACC", acc), ("EER", eer), ("AUC", auc)]
    for f in fprs or []:
        out.append((f"TPR@FPR={f}", 100.0 * float(roc(float(f)))))
    return out
