"""Batched face analysis, detect -> expand bbox -> crop chip -> align (a frozen
copy of fairdiff_torch/guidance/faces.py for the benchmark's reference).

One fixed-shape function over the batch, differentiable in the images (the
crops and warps are bilinear), with the reference's -1 fill contract for
lanes without a face.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import geometry as geo


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


