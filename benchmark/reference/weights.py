"""Dynamic loss weights and the face-region gradient mask (a frozen copy of
fairdiff_torch/fairness/weights.py for the benchmark's reference).

- `dynamic_weights_multi`: the image-preservation loss weight per lane, 1
  where every attribute keeps its original prediction, else the smallest
  factor of the attributes that change (exp-1 gives lanes without a face
  weight 1).
- `face_region_grad_scale_multi`: identity forward; the backward scales the
  image gradient inside the intersection of the current and the original
  face box by that factor (the reference's `apply_grad_hook_face`), through
  the autograd Function `ScaleGradRegion` (the JAX custom_vjp
  `_scale_grad_region`).
"""

from __future__ import annotations

import torch


def keep_identity(targets: torch.Tensor, preds_ori: torch.Tensor) -> torch.Tensor:
    """True where the target keeps the originally predicted class."""
    return (targets == preds_ori) & (targets != -1)


def multi_attr_factor(
    targets: dict[str, torch.Tensor],
    preds_ori: dict[str, torch.Tensor],
    factors: dict[str, float],
) -> torch.Tensor:
    """Per lane: 1 if every attribute keeps its prediction, else the MIN of
    the factors of the attributes that change (target -1 counts as changed)."""
    names = list(targets)
    out = torch.ones(targets[names[0]].shape, dtype=torch.float32, device=targets[names[0]].device)
    for name in names:
        v = torch.where(keep_identity(targets[name], preds_ori[name]), 1.0, factors[name])
        out = torch.minimum(out, v)
    return out


def dynamic_weights_multi(
    face_indicators: torch.Tensor,
    targets: dict[str, torch.Tensor],
    preds_ori: dict[str, torch.Tensor],
    factors: dict[str, float],
    no_face_weight: float | None = None,
) -> torch.Tensor:
    """exp-1 passes no_face_weight=1; None gives min(factors) (exp-3+)."""
    if no_face_weight is None:
        no_face_weight = min(factors.values())
    return torch.where(face_indicators, multi_attr_factor(targets, preds_ori, factors), no_face_weight)


class ScaleGradRegion(torch.autograd.Function):
    """Identity forward; the backward multiplies the cotangent by `scale_map`."""

    @staticmethod
    def forward(ctx, images, scale_map):
        ctx.save_for_backward(scale_map)
        return images.view_as(images)

    @staticmethod
    def backward(ctx, g):
        (scale_map,) = ctx.saved_tensors
        return g * scale_map, None


def _scale_face_region(
    images: torch.Tensor,  # [N, H, W, C]
    face_bboxes: torch.Tensor,  # [N, 4], -1 fill
    face_bboxes_ori: torch.Tensor,  # [N, 4], -1 fill
    f: torch.Tensor,  # [N] the factor of each lane
) -> torch.Tensor:
    _, h, w, _ = images.shape
    b = face_bboxes.clamp_min(0).float()
    bo = face_bboxes_ori.float()
    x0 = torch.maximum(b[:, 0], bo[:, 0]).clamp_min(0.0)
    y0 = torch.maximum(b[:, 1], bo[:, 1]).clamp_min(0.0)
    x1 = torch.minimum(b[:, 2], bo[:, 2]).clamp_max(float(w))
    y1 = torch.minimum(b[:, 3], bo[:, 3]).clamp_max(float(h))
    ys = torch.arange(h, dtype=torch.float32, device=images.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=images.device)[None, None, :]
    masks = (
        (xs >= x0[:, None, None]) & (xs < x1[:, None, None])
        & (ys >= y0[:, None, None]) & (ys < y1[:, None, None])
    ).float()
    has_face = (face_bboxes != -1).any(dim=-1)
    scale = torch.where(has_face[:, None, None], masks * f[:, None, None] + (1.0 - masks), 1.0)
    return ScaleGradRegion.apply(images, scale[..., None].to(images.dtype))


def face_region_grad_scale_multi(
    images: torch.Tensor,  # [N, H, W, C]
    face_bboxes: torch.Tensor,  # [N, 4], -1 fill
    face_bboxes_ori: torch.Tensor,  # [N, 4], -1 fill
    targets: dict[str, torch.Tensor],
    preds_ori: dict[str, torch.Tensor],
    factors: dict[str, float],
) -> torch.Tensor:
    return _scale_face_region(images, face_bboxes, face_bboxes_ori, multi_attr_factor(targets, preds_ori, factors))
