"""Composite fairness loss, phase-4 semantics of the reference's train step (a
frozen copy of fairdiff_torch/fairness/losses.py for the benchmark's
reference).

  loss = loss_fair + w_img * dyn_w * (loss_CLIP + loss_DINO) + w_face * loss_face

loss_fair and loss_face are masked to 0 on invalid lanes (the reference's
constant -1 there carries no gradient; the chunk mean still divides by the
full lane count); the returned per-lane logs keep the -1s.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch



class FairLossOutput(NamedTuple):
    total: torch.Tensor  # scalar, mean over lanes
    logs: dict


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-sample CE with arbitrary (possibly -1) targets; the caller masks."""
    logp = torch.log_softmax(logits, dim=-1)
    safe_t = targets.clamp(0, logits.shape[-1] - 1).long()
    return -torch.gather(logp, -1, safe_t[:, None])[:, 0]


def cosine_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return 1.0 - (a * b).sum(dim=-1)


def fair_ce_loss(
    logits: torch.Tensor, targets: torch.Tensor, face_indicators: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (per-lane CE masked to 0, valid mask)."""
    valid = face_indicators & (targets != -1)
    ce = cross_entropy(logits.float(), targets)
    return torch.where(valid, ce, 0.0), valid


def composite_loss(
    *,
    loss_fair: torch.Tensor,
    loss_clip: torch.Tensor,
    loss_dino: torch.Tensor,
    loss_face: torch.Tensor,
    dynamic_w: torch.Tensor,
    weight_img: float = 8.0,
    weight_face: float = 1.0,
    fair_valid: Optional[torch.Tensor] = None,
    face_valid: Optional[torch.Tensor] = None,
) -> FairLossOutput:
    per_lane = loss_fair + weight_img * dynamic_w * (loss_clip + loss_dino) + weight_face * loss_face
    logs = {
        "loss_fair": torch.where(
            fair_valid if fair_valid is not None else loss_fair != 0, loss_fair, -1.0
        ),
        "loss_face": torch.where(
            face_valid if face_valid is not None else loss_face != 0, loss_face, -1.0
        ),
        "loss_CLIP": loss_clip,
        "loss_DINO": loss_dino,
        "loss": per_lane,
    }
    return FairLossOutput(per_lane.mean(), logs)
