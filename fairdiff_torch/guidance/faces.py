"""Batched face analysis, detect -> expand bbox -> crop chip -> align
(counterpart of fairdiff/guidance/faces.py), and the two-stage detector.

One fixed-shape function over the batch, differentiable in the images (the
crops and warps are bilinear), with the reference's -1 fill contract for
lanes without a face. `compose_detectors` fills the lanes a primary
detector misses from a fallback, as the reference consults dlib only where
insightface found nothing.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from fairdiff_torch.guidance import geometry as geo


class FaceDetections(NamedTuple):
    """Per-image single best face (fairdiff/models/face_detector.py)."""

    indicators: torch.Tensor  # [N] bool
    bboxes: torch.Tensor  # [N, 4] float (x0, y0, x1, y1), -1 fill
    landmarks: torch.Tensor  # [N, 5, 2] float, -1 fill
    scores: torch.Tensor  # [N] float, -1 fill


class FaceAnalysis(NamedTuple):
    indicators: torch.Tensor  # [N] bool
    bboxes: torch.Tensor  # [N, 4] int32 (expanded), -1 fill
    chips: torch.Tensor  # [N, S, S, 3] in [-1, 1], fill rows
    landmarks: torch.Tensor  # [N, 5, 2], -1 fill
    aligned: torch.Tensor  # [N, A, A, 3], fill rows


def analyze_faces(
    images: torch.Tensor,  # [N, H, W, 3] in [-1, 1]
    detections: FaceDetections,
    *,
    chip_size: int = 224,
    aligned_size: int = 112,
    expand_coef: float = 0.5,
    fill_value: float = -1.0,
) -> FaceAnalysis:
    """detect -> expand(0.5, ratio 1) -> crop chip -> landmark-align; lanes
    without a face warp a placeholder box and are then filled."""
    ind = detections.indicators
    dev = images.device
    safe_box = torch.where(
        ind[:, None], detections.bboxes.float(), torch.tensor([0.0, 0.0, 32.0, 32.0], device=dev)
    )
    expanded = geo.expand_bbox(safe_box, expand_coef, 1.0)
    chips = geo.crop_and_resize(images, expanded, chip_size, fill_value)
    template = torch.as_tensor(geo.ARCFACE_TEMPLATE, device=dev)
    safe_lms = torch.where(ind[:, None, None], detections.landmarks.float(), template)
    aligned = geo.align_faces(images, safe_lms, aligned_size, fill_value)

    def fill(x: torch.Tensor) -> torch.Tensor:
        return torch.where(ind.reshape((-1,) + (1,) * (x.dim() - 1)), x, fill_value)

    return FaceAnalysis(
        indicators=ind,
        bboxes=torch.where(ind[:, None], expanded, torch.tensor(int(fill_value), dtype=torch.int32, device=dev)),
        chips=fill(chips),
        landmarks=fill(safe_lms),
        aligned=fill(aligned),
    )


def merge_detections(a: FaceDetections, b: FaceDetections) -> FaceDetections:
    """Lanes `a` missed are filled from `b` (the reference's two-stage
    semantics: the fallback is consulted only where the primary found
    nothing)."""
    use_b = ~a.indicators

    def pick(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.where(use_b.reshape((-1,) + (1,) * (x.dim() - 1)), y, x)

    return FaceDetections(
        indicators=a.indicators | b.indicators,
        bboxes=pick(a.bboxes, b.bboxes),
        landmarks=pick(a.landmarks, b.landmarks),
        scores=pick(a.scores, b.scores),
    )


def compose_detectors(
    primary: Callable[[torch.Tensor], FaceDetections],
    fallback: Callable[[torch.Tensor], FaceDetections],
) -> Callable[[torch.Tensor], FaceDetections]:
    """detect(images): both run batched, and the lanes the primary misses
    are filled from the fallback."""

    def detect(images: torch.Tensor) -> FaceDetections:
        return merge_detections(primary(images), fallback(images))

    return detect


def compose_detect_fns(
    primary: Callable[..., FaceDetections],
    fallback: Callable[..., FaceDetections],
) -> Callable[..., FaceDetections]:
    """The same for detectors that take their weights first,
    `detect(params, images)` with `params = {"primary": ..., "fallback":
    ...}` (as `io.onnx_bridge.load_scrfd` returns its detector)."""

    def detect(params, images: torch.Tensor) -> FaceDetections:
        return merge_detections(primary(params["primary"], images), fallback(params["fallback"], images))

    return detect
