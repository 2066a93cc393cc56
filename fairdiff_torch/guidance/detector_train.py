"""Face-detector training: anchor assignment and losses in torch, the
synthetic face scenes and the held-out benchmark (counterpart of
fairdiff/guidance/detector_train.py).

The scene renderers are numpy code copied from the JAX module, so one
`np.random.Generator` gives the same scenes, bit for bit, in both packages:
landmark-true face blobs (an elliptical skin-tone blob with dark dots at
similarity-transformed ArcFace template positions), non-face distractors,
the domain-randomized (`dr`) scenes of the shipped recipe, and the
distribution-shifted suites of the benchmark. `evaluate_detector` and
`false_positive_rate` score a `detect(images) -> FaceDetections` callable
(`models.face_detector.make_detect_fn`); `detection_loss` is SCRFD-style
per-level assignment with focal BCE, box and landmark L1 and the stride-4
rescue floor, on the port's `FaceDetectorNet`.
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from fairdiff_torch.device import resolve_device
from fairdiff_torch.guidance.faces import FaceDetections
from fairdiff_torch.guidance.geometry import ARCFACE_TEMPLATE
from fairdiff_torch.models.face_detector import DetectorConfig, FaceDetectorNet

# ---------------------------------------------------------------------------
# synthetic data (numpy, as the JAX module draws it)
# ---------------------------------------------------------------------------

def _paint_blob(img: np.ndarray, rng: np.random.Generator) -> None:
    """A non-face distractor: random-color ellipse with NO landmark
    structure — hard negatives that teach the score head that 'skin-tone
    blob' alone is not a face."""
    size = img.shape[0]
    cx, cy = rng.uniform(0.1, 0.9, 2) * size
    hw, hh = rng.uniform(0.05, 0.25, 2) * size
    ys, xs = np.mgrid[0:size, 0:size]
    ell = ((xs - cx) / hw) ** 2 + ((ys - cy) / hh) ** 2 <= 1.0
    color = rng.uniform(-0.8, 0.8, 3)
    img[ell] = color + rng.normal(0, 0.05, (int(ell.sum()), 3))


def _paint_face(
    img: np.ndarray,
    rng: np.random.Generator,
    scale_range: tuple[float, float] = (0.25, 0.9),
    center_range: tuple[float, float] = (0.3, 0.7),
    center: tuple[float, float] | None = None,  # explicit (cx,cy) fractions
    skin_base: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Paint one landmark-true face into `img`; -> (bbox [4], lms [5,2])."""
    size = img.shape[0]
    scale = rng.uniform(*scale_range) * size / 112.0
    if center is not None:
        cx, cy = center[0] * size, center[1] * size
    else:
        cx = rng.uniform(*center_range) * size
        cy = rng.uniform(*center_range) * size
    lms = (ARCFACE_TEMPLATE - 56.0) * scale + np.array([cx, cy])
    half_w, half_h = 52.0 * scale, 60.0 * scale

    ys, xs = np.mgrid[0:size, 0:size]
    ell = ((xs - cx) / half_w) ** 2 + ((ys - cy) / (half_h)) ** 2 <= 1.0
    if skin_base is None:
        skin_base = np.array([0.55, 0.25, 0.05])
    skin = skin_base + rng.normal(0, 0.05, 3)
    img[ell] = skin + rng.normal(0, 0.05, (int(ell.sum()), 3))
    for lx, ly in lms:
        r = max(1, int(2 * scale))
        y0, y1 = int(ly) - r, int(ly) + r + 1
        x0, x1 = int(lx) - r, int(lx) + r + 1
        # clamp STOPS at 0 too: a landmark past the left/top edge gives a
        # negative stop, and img[a:-13] would paint a near-full-width band
        # (hit by the DR renderer's edge centers/large scales — corrupted
        # ~2% of DR scenes before the r4 fix)
        img[max(y0, 0) : max(y1, 0), max(x0, 0) : max(x1, 0)] = -0.7
    bbox = np.array([cx - half_w, cy - half_h, cx + half_w, cy + half_h])
    return bbox.astype(np.float32), lms.astype(np.float32)


def render_face_scene(
    rng: np.random.Generator, size: int = 128, distractors: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (image [size,size,3] in [-1,1], bbox [4], landmarks [5,2]).

    A face is an elliptical skin-tone blob with dark eye/nose/mouth dots at
    similarity-transformed ArcFace template positions — geometry-true, so a
    detector trained on it learns real localisation/landmark regression.
    `distractors` adds that many non-face blobs painted BEFORE the face
    (the face may partially occlude them, never the reverse).
    """
    img = rng.normal(0.0, 0.15, (size, size, 3)).astype(np.float32)
    for _ in range(distractors):
        _paint_blob(img, rng)
    bbox, lms = _paint_face(img, rng)
    return np.clip(img, -1, 1), bbox, lms


def render_negative_scene(
    rng: np.random.Generator, size: int = 128, distractors: int = 2
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Face-free scene (textured noise + distractor blobs). Ground truth is
    the -1 fill contract: bbox [-1]*4, landmarks -1 — `_level_targets`
    yields zero positives for it (degenerate box fails both the inside and
    the scale gate), so the loss reduces to pure score suppression."""
    img = rng.normal(0.0, 0.15, (size, size, 3)).astype(np.float32)
    n_blobs = int(rng.integers(1, distractors + 1)) if distractors > 0 else 0
    for _ in range(n_blobs):
        _paint_blob(img, rng)
    return (
        np.clip(img, -1, 1),
        np.full(4, -1.0, np.float32),
        np.full((5, 2), -1.0, np.float32),
    )


def render_face_scene_dr(
    rng: np.random.Generator, size: int = 128,
    lead_scale_range: tuple[float, float] | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Domain-randomized face scene (round-4 robustness training).

    The r3-trained detector collapsed on the distribution shifts the
    eval suite probes (docs/DETECTOR.md: recall 0.34 on scale_small,
    0.63 on low_contrast, 0.74 on skin_tone) because render_face_scene
    fixes every one of those axes. This renderer samples them all
    CONTINUOUSLY, with ranges at least as wide as the eval suite's fixed
    points: background (noise or structured), 1-3 faces (ground truth =
    largest, the detect_fn contract), log-uniform scale 0.15-1.35 (the
    anchor-assignable floor — see the scale-gate comment below),
    centers to the frame edge, a light-to-dark skin-tone continuum,
    occluders painted AFTER the face, optional blur and contrast
    compression. After training on this, the shifted suite is no longer
    fully out-of-distribution — it becomes axis coverage; the remaining
    honest OOD statement is real photographs (environmental, see
    docs/DETECTOR.md caveats)."""
    if rng.uniform() < 0.3:
        img = _structured_background(rng, size)
    else:
        img = rng.normal(0.0, 0.15, (size, size, 3)).astype(np.float32)
    for _ in range(int(rng.integers(0, 4))):
        _paint_blob(img, rng)

    def sample_tone():
        light = np.array([0.85, 0.65, 0.50])
        dark = np.array([0.10, -0.10, -0.25])
        t = rng.uniform()
        return light * (1 - t) + dark * t + rng.normal(0, 0.04, 3)

    # scale floor 0.12 = the eval suite's scale_small low end. With the
    # r5 stride-4 P2 level (strides 4,8,16,32), the standard gates
    # assign sqrt(bw*bh) in [8, 320) px, so a 13.4 px (s=0.12) face has
    # real inside-window anchors; the nearest-center rescue on the
    # smallest level (1.25*stride = 5 px) is a guarantee below/beside
    # the windows, not the binding floor. Lowering the renderer floor
    # further (0.095, tried under the r5 3-level gates) was MEASURED
    # WORSE (DETECTOR.md r5): faces below the eval range dilute
    # capacity and drag box/landmark regression down across every shift
    # (mean IoU 0.89 -> 0.80).
    # lead_scale_range overrides the lead face's scale band (used by the
    # hard-positive side of train_detector's mining phase to keep
    # small-face recall pressured while mined negatives teach
    # suppression); single-face in that mode so the override stays the
    # largest-face ground truth
    if lead_scale_range is not None:
        n_faces = 1
    else:
        n_faces = 1 if rng.uniform() < 0.7 else int(rng.integers(2, 4))
    best = None
    for i in range(n_faces):
        scale_range = (
            (lead_scale_range or (0.12, 1.35)) if i == 0 else (0.12, 0.5)
        )
        lo, hi = np.log(scale_range[0]), np.log(scale_range[1])
        s = float(np.exp(rng.uniform(lo, hi)))
        bbox, lms = _paint_face(
            img, rng, scale_range=(s, s), center_range=(0.08, 0.92),
            skin_base=sample_tone(),
        )
        area = (bbox[2] - bbox[0]) * (bbox[3] - bbox[1])
        if best is None or area > best[0]:
            best = (area, bbox, lms)
    bbox, lms = best[1], best[2]

    if rng.uniform() < 0.3:  # occluder over the gt face (painted after)
        cx = rng.uniform(bbox[0], bbox[2])
        cy = rng.uniform(bbox[1], bbox[3])
        w = rng.uniform(0.05, 0.14) * size
        ys, xs = np.mgrid[0:size, 0:size]
        ell = ((xs - cx) / w) ** 2 + ((ys - cy) / w) ** 2 <= 1.0
        img[ell] = rng.uniform(-0.8, 0.8, 3) + rng.normal(
            0, 0.05, (int(ell.sum()), 3)
        )
    if rng.uniform() < 0.3:
        img = _gaussian_blur(img, rng.uniform(0.5, 2.5))
    if rng.uniform() < 0.3:
        img = img * rng.uniform(0.35, 1.0) + rng.uniform(-0.3, 0.3)
    return np.clip(img, -1, 1), bbox, lms


def render_negative_scene_dr(
    rng: np.random.Generator, size: int = 128
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Face-free DR scene: structured backgrounds and contrast shifts
    must NOT become face cues, so negatives sample them too."""
    if rng.uniform() < 0.3:
        img = _structured_background(rng, size)
    else:
        img = rng.normal(0.0, 0.15, (size, size, 3)).astype(np.float32)
    for _ in range(int(rng.integers(1, 4))):
        _paint_blob(img, rng)
    if rng.uniform() < 0.3:
        img = _gaussian_blur(img, rng.uniform(0.5, 2.5))
    if rng.uniform() < 0.3:
        img = img * rng.uniform(0.35, 1.0) + rng.uniform(-0.3, 0.3)
    return (
        np.clip(img, -1, 1),
        np.full(4, -1.0, np.float32),
        np.full((5, 2), -1.0, np.float32),
    )


def synthetic_batches(
    batch_size: int,
    size: int = 128,
    seed: int = 0,
    neg_frac: float = 0.0,
    distractors: int = 0,
    scenes: str = "base",  # "base" (r1 renderer) | "dr" (domain-randomized)
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    if scenes == "dr":
        pos = lambda: render_face_scene_dr(rng, size)
        neg = lambda: render_negative_scene_dr(rng, size)
    else:
        pos = lambda: render_face_scene(rng, size, distractors)
        neg = lambda: render_negative_scene(rng, size, distractors)
    while True:
        scene_list = [
            neg() if rng.uniform() < neg_frac else pos()
            for _ in range(batch_size)
        ]
        imgs, boxes, lms = zip(*scene_list)
        yield np.stack(imgs), np.stack(boxes), np.stack(lms)


# ---------------------------------------------------------------------------
# distribution-shifted scenes (VERDICT r3 #5): the held-out benchmark below
# draws from the SAME renderer the detector trained on, so its 0.996 recall
# is circular evidence. Each generator below breaks one training-
# distribution assumption while keeping the ground-truth contract (single
# largest face, -1 fill for none) — recall under these shifts measures
# generalisation, not memorisation of the renderer.
# ---------------------------------------------------------------------------

def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable gaussian blur, numpy-only (no cv2/scipy dependency)."""
    radius = max(int(3.0 * sigma + 0.5), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    out = np.apply_along_axis(np.convolve, 0, img, k, "same")
    out = np.apply_along_axis(np.convolve, 1, out, k, "same")
    return out.astype(np.float32)


def _structured_background(
    rng: np.random.Generator, size: int
) -> np.ndarray:
    """Stripes + smooth gradients instead of the training gaussian noise."""
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32) / size
    theta = rng.uniform(0, np.pi)
    freq = rng.uniform(3, 12)
    phase = rng.uniform(0, 2 * np.pi)
    stripes = np.sin(
        2 * np.pi * freq * (np.cos(theta) * xs + np.sin(theta) * ys) + phase
    )
    grad = rng.uniform(-0.5, 0.5) * xs + rng.uniform(-0.5, 0.5) * ys
    base = rng.uniform(-0.4, 0.4, 3).astype(np.float32)
    img = (
        base[None, None]
        + 0.3 * stripes[..., None]
        + grad[..., None]
    ).astype(np.float32)
    return img


def shifted_scene_fns(size: int = 128) -> dict:
    """name -> scene_fn(rng) generators, each shifted from the TRAINING
    distribution (render_face_scene: noise background, scale 0.25-0.9,
    center 0.3-0.7, fixed skin tone, no blur/occlusion, distractors only
    BEHIND the face) along exactly one axis."""

    def blur(rng, sigma_range=(1.0, 2.0)):
        img, bbox, lms = render_face_scene(rng, size, distractors=2)
        return _gaussian_blur(img, rng.uniform(*sigma_range)), bbox, lms

    def occlusion(rng):
        # blobs painted AFTER the face cover part of it — training scenes
        # never occlude the face (blobs render first)
        img = rng.normal(0.0, 0.15, (size, size, 3)).astype(np.float32)
        bbox, lms = _paint_face(img, rng)
        cx = rng.uniform(bbox[0], bbox[2]) / size
        cy = rng.uniform(bbox[1], bbox[3]) / size
        # one blob anchored on the face edge (partial cover), one random
        w = rng.uniform(0.06, 0.14)
        ys, xs = np.mgrid[0:size, 0:size]
        ell = (
            ((xs - cx * size) / (w * size)) ** 2
            + ((ys - cy * size) / (w * size)) ** 2
            <= 1.0
        )
        img[ell] = rng.uniform(-0.8, 0.8, 3) + rng.normal(
            0, 0.05, (int(ell.sum()), 3)
        )
        _paint_blob(img, rng)
        return np.clip(img, -1, 1), bbox, lms

    def small(rng):
        img = rng.normal(0.0, 0.15, (size, size, 3)).astype(np.float32)
        for _ in range(2):
            _paint_blob(img, rng)
        bbox, lms = _paint_face(img, rng, scale_range=(0.12, 0.25))
        return np.clip(img, -1, 1), bbox, lms

    def large(rng):
        img = rng.normal(0.0, 0.15, (size, size, 3)).astype(np.float32)
        bbox, lms = _paint_face(img, rng, scale_range=(0.9, 1.3))
        return np.clip(img, -1, 1), bbox, lms

    def offcenter(rng):
        # face centers out to the frame edge -> partially cropped faces
        img = rng.normal(0.0, 0.15, (size, size, 3)).astype(np.float32)
        for _ in range(2):
            _paint_blob(img, rng)
        bbox, lms = _paint_face(
            img, rng, scale_range=(0.25, 0.6), center_range=(0.1, 0.9)
        )
        return np.clip(img, -1, 1), bbox, lms

    def multiface(rng):
        # 2-3 faces; ground truth is the LARGEST (the detect_fn contract:
        # largest-area selection, guidance/faces.py)
        img = rng.normal(0.0, 0.15, (size, size, 3)).astype(np.float32)
        centers = [(0.28, 0.3), (0.72, 0.3), (0.5, 0.72)]
        rng.shuffle(centers)
        n_faces = int(rng.integers(2, 4))
        best = None
        for c in centers[:n_faces]:
            bbox, lms = _paint_face(
                img, rng, scale_range=(0.2, 0.45), center=c
            )
            area = (bbox[2] - bbox[0]) * (bbox[3] - bbox[1])
            if best is None or area > best[0]:
                best = (area, bbox, lms)
        return np.clip(img, -1, 1), best[1], best[2]

    def skin_tone(rng):
        # training uses ONE fixed skin base; sample light-to-dark tones
        img = rng.normal(0.0, 0.15, (size, size, 3)).astype(np.float32)
        for _ in range(2):
            _paint_blob(img, rng)
        tones = np.array([
            [0.80, 0.60, 0.45],  # light
            [0.65, 0.40, 0.20],
            [0.40, 0.15, -0.05],
            [0.15, -0.05, -0.20],  # dark
        ])
        base = tones[rng.integers(len(tones))]
        bbox, lms = _paint_face(img, rng, skin_base=base)
        return np.clip(img, -1, 1), bbox, lms

    def low_contrast(rng):
        img, bbox, lms = render_face_scene(rng, size, distractors=2)
        shift = rng.uniform(-0.3, 0.3)
        return np.clip(img * 0.45 + shift, -1, 1), bbox, lms

    def textured_bg(rng):
        img = _structured_background(rng, size)
        _paint_blob(img, rng)
        bbox, lms = _paint_face(img, rng)
        return np.clip(img, -1, 1), bbox, lms

    return {
        "blur": blur,
        "occlusion": occlusion,
        "scale_small": small,
        "scale_large": large,
        "offcenter": offcenter,
        "multiface": multiface,
        "skin_tone": skin_tone,
        "low_contrast": low_contrast,
        "textured_bg": textured_bg,
    }


# ---------------------------------------------------------------------------
# held-out evaluation
# ---------------------------------------------------------------------------

def _iou(a: np.ndarray, b: np.ndarray) -> float:
    ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
    ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(ix1 - ix0, 0.0) * max(iy1 - iy0, 0.0)
    area = lambda r: max(r[2] - r[0], 0.0) * max(r[3] - r[1], 0.0)
    union = area(a) + area(b) - inter
    return inter / union if union > 0 else 0.0


def _detect(detect_fn: Callable[[torch.Tensor], FaceDetections], imgs: np.ndarray,
            device: torch.device) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    det = detect_fn(torch.as_tensor(imgs, device=device))
    return det.indicators.cpu().numpy(), det.bboxes.cpu().numpy(), det.landmarks.cpu().numpy()


def evaluate_detector(
    detect_fn: Callable[[torch.Tensor], FaceDetections],
    *,
    n_scenes: int = 256,
    size: int = 128,
    seed: int = 9999,
    iou_thresh: float = 0.5,
    distractors: int = 2,
    batch: int = 32,
    scene_fn=None,
    neg_fn=None,
    device: torch.device | str | None = None,
) -> dict[str, float]:
    """Held-out benchmark: recall, IoU and landmark error on fresh face
    scenes (with distractor blobs) and the false-positive rate on face-free
    scenes, the scenes made on the host and detected on `device` (None:
    CUDA). A lane counts as a hit only when the detector fires and its box
    overlaps the ground truth at >= `iou_thresh`.

    `scene_fn(rng) -> (img, bbox, lms)` replaces the positive scenes
    (default: the training renderer); `neg_fn(rng)` the face-free ones, and
    `neg_fn=False` skips them (no "fp_rate" key: a shift sweep prices fp once
    a background family with `false_positive_rate`)."""
    device = resolve_device(device)
    if scene_fn is None:
        scene_fn = lambda r: render_face_scene(r, size, distractors)
    if neg_fn is None:
        neg_fn = lambda r: render_negative_scene(r, size)
    rng = np.random.default_rng(seed)
    hits = fired = 0
    ious: list[float] = []
    lm_errs: list[float] = []
    fp = 0
    # n_scenes < batch still runs (and counts) one full batch
    n_batches = max(n_scenes // batch, 1)
    for _ in range(n_batches):
        pos = [scene_fn(rng) for _ in range(batch)]
        imgs, boxes, lms = (np.stack(z) for z in zip(*pos))
        ind, got_b, got_l = _detect(detect_fn, imgs, device)
        for i in range(batch):
            if not ind[i]:
                continue
            fired += 1
            iou = _iou(got_b[i], boxes[i])
            if iou >= iou_thresh:
                hits += 1
                ious.append(iou)
                scale = (boxes[i, 2] - boxes[i, 0]) / 104.0  # vs the 112-px template
                err = np.linalg.norm(got_l[i] - lms[i], axis=-1).mean()
                lm_errs.append(float(err / max(scale, 1e-6)))
        if neg_fn is not False:
            nimgs = np.stack([neg_fn(rng)[0] for _ in range(batch)])
            fp += int(_detect(detect_fn, nimgs, device)[0].sum())

    n = n_batches * batch
    out = {
        "n_scenes": float(n),
        "recall": hits / n,
        "det_rate": fired / n,
        "mean_iou": float(np.mean(ious)) if ious else 0.0,
        # mean landmark error in 112-aligned-template pixel units
        "lm_err_112px": float(np.mean(lm_errs)) if lm_errs else -1.0,
    }
    if neg_fn is not False:
        out["fp_rate"] = fp / n
    return out


def false_positive_rate(
    detect_fn: Callable[[torch.Tensor], FaceDetections],
    *,
    n_scenes: int = 256,
    size: int = 128,
    seed: int = 9999,
    batch: int = 32,
    neg_fn=None,
    device: torch.device | str | None = None,
) -> float:
    """Fraction of face-free scenes the detector fires on (detected on
    `device`, None: CUDA)."""
    device = resolve_device(device)
    if neg_fn is None:
        neg_fn = lambda r: render_negative_scene(r, size)
    rng = np.random.default_rng(seed)
    fp = 0
    n_batches = max(n_scenes // batch, 1)
    for _ in range(n_batches):
        nimgs = np.stack([neg_fn(rng)[0] for _ in range(batch)])
        fp += int(_detect(detect_fn, nimgs, device)[0].sum())
    return fp / (n_batches * batch)


def shifted_negative_fns(size: int = 128) -> dict:
    """Face-free counterparts of the shifts that transform the BACKGROUND
    (blur, textured_bg, low_contrast). The remaining shifts alter only the
    face geometry/appearance, so their face-free scenes are identical to
    the base negative distribution — a per-shift fp there would relabel
    the same number nine times (r4 review finding)."""
    neg_contract = (
        np.full(4, -1.0, np.float32),
        np.full((5, 2), -1.0, np.float32),
    )

    def blur(rng):
        img, b, l = render_negative_scene(rng, size)
        return _gaussian_blur(img, rng.uniform(1.0, 2.0)), b, l

    def low_contrast(rng):
        img, b, l = render_negative_scene(rng, size)
        shift = rng.uniform(-0.3, 0.3)
        return np.clip(img * 0.45 + shift, -1, 1).astype(np.float32), b, l

    def textured_bg(rng):
        img = _structured_background(rng, size)
        _paint_blob(img, rng)
        return np.clip(img, -1, 1), *neg_contract

    return {
        "blur": blur,
        "low_contrast": low_contrast,
        "textured_bg": textured_bg,
    }


# ---------------------------------------------------------------------------
# assignment + loss
# ---------------------------------------------------------------------------

def _level_targets(
    boxes: torch.Tensor,  # [N, 4]
    lms: torch.Tensor,  # [N, 5, 2]
    hw: tuple[int, int],
    stride: int,
    num_anchors: int,
    *,
    rescue_floor: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (pos [N, h, w, A], box distances [N, h, w, 4], landmark offsets
    [N, h, w, 5, 2]), both in stride units. A positive is a grid centre
    inside the central half of the box whose scale sqrt(bw * bh) fits the
    level, [2, 10) strides (SCRFD-style). With `rescue_floor` (the smallest
    level), a face of scale [rescue_floor, 10 strides) also gets the grid
    point nearest its centre: the central-half window of a face near the
    floor can fall between grid points."""
    h, w = hw
    cy = (torch.arange(h, dtype=torch.float32, device=boxes.device) * stride).reshape(1, h, 1)
    cx = (torch.arange(w, dtype=torch.float32, device=boxes.device) * stride).reshape(1, 1, w)
    x0, y0, x1, y1 = (boxes[:, i].reshape(-1, 1, 1) for i in range(4))
    bw, bh = x1 - x0, y1 - y0
    ctr_x, ctr_y = (x0 + x1) / 2, (y0 + y1) / 2
    inside = (cx > ctr_x - bw / 4) & (cx < ctr_x + bw / 4) & (cy > ctr_y - bh / 4) & (cy < ctr_y + bh / 4)
    scale = torch.sqrt(bw * bh)
    fits = (scale >= stride * 2) & (scale < stride * 10)
    pos = (inside & fits).float()  # [N, h, w]
    if rescue_floor is not None:
        fits_r = (scale >= rescue_floor) & (scale < stride * 10)  # [N, 1, 1]
        d2 = (cx - ctr_x) ** 2 + (cy - ctr_y) ** 2  # [N, h, w]
        nearest = F.one_hot(d2.reshape(d2.shape[0], -1).argmin(-1), h * w).reshape(d2.shape).float()
        pos = torch.maximum(pos, nearest * fits_r.float())
    pos = pos[..., None].repeat(1, 1, 1, num_anchors)
    d = torch.stack([cx - x0 + 0 * cy, cy - y0 + 0 * cx, x1 - cx + 0 * cy, y1 - cy + 0 * cx], -1) / stride
    zero_hw = (0 * cx + 0 * cy)[..., None]  # [1, h, w, 1]
    kx = lms[:, None, None, :, 0] - cx[..., None] + zero_hw
    ky = lms[:, None, None, :, 1] - cy[..., None] + zero_hw
    return pos, d, torch.stack([kx, ky], -1) / stride


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with jax.numpy's gradient: 1 at 0 (torch's `abs` gives 0 there,
    which a regression target met exactly, e.g. a landmark on a grid point
    of a blank image, would see)."""
    return torch.where(x >= 0, x, -x)


def detection_loss(
    net: FaceDetectorNet,
    images: torch.Tensor,  # [N, H, W, 3] in [-1, 1]
    boxes: torch.Tensor,  # [N, 4], -1 fill for a face-free scene
    lms: torch.Tensor,  # [N, 5, 2], -1 fill
    cfg: DetectorConfig,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Focal BCE over every anchor (over N * 100) plus the box and 0.2 x the
    landmark L1 over the positives -> (loss, {"cls", "box", "kps", "n_pos"})."""
    raw = net(images)
    total_cls = total_box = total_kps = n_pos_total = torch.zeros((), device=images.device)
    smallest = min(cfg.strides)
    for score, bbox, kps, stride in zip(raw["score"], raw["bbox"], raw["kps"], cfg.strides):
        n, h, w, a = score.shape
        pos, d_tgt, k_tgt = _level_targets(
            boxes, lms, (h, w), stride, a, rescue_floor=1.25 * stride if stride == smallest else None)
        p = torch.sigmoid(score.float())
        bce = -(pos * torch.log(p.clamp(min=1e-7)) * (1 - p) ** 2
                + (1 - pos) * torch.log((1 - p).clamp(min=1e-7)) * p**2)
        total_cls = total_cls + bce.sum()
        bbox = bbox.reshape(n, h, w, a, 4).float()
        kps = kps.reshape(n, h, w, a, 5, 2).float()
        box_err = _abs(bbox - d_tgt[:, :, :, None, :]).sum(-1)
        kps_err = _abs(kps - k_tgt[:, :, :, None, :, :]).sum((-1, -2))
        total_box = total_box + (pos * box_err).sum()
        total_kps = total_kps + (pos * kps_err).sum()
        n_pos_total = n_pos_total + pos.sum()
    n_pos_total = n_pos_total.clamp(min=1.0)
    cls = total_cls / (images.shape[0] * 100.0)
    box, kp = total_box / n_pos_total, total_kps / n_pos_total
    return cls + box + 0.2 * kp, {"cls": cls, "box": box, "kps": kp, "n_pos": n_pos_total}
