"""Attribute-classifier heads with the reference's -1 fill contract (a frozen
copy of fairdiff_torch/guidance/attributes.py for the benchmark's
reference).

Every image runs through the classifier (lanes without a face compute on
fill chips) and invalid rows are overwritten with the fill value, so
downstream code sees the reference's contract (`probs == -1` rows are
skipped by target generation).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch


class AttributeOutput(NamedTuple):
    preds: torch.Tensor  # [N] int32, fill where no face
    probs: torch.Tensor  # [N, C], fill rows where no face
    logits: torch.Tensor  # [N, C], fill rows where no face


@dataclasses.dataclass(frozen=True)
class AttributeSlices:
    """How to cut per-attribute logits out of a classifier's output."""

    extract: Callable[[torch.Tensor], dict[str, torch.Tensor]]


def celeba_slices() -> AttributeSlices:
    """CelebA 80-logit head: 40 attributes x 2; gender is attribute 20."""

    def extract(logits: torch.Tensor) -> dict[str, torch.Tensor]:
        return {"gender": logits.reshape(logits.shape[0], -1, 2)[:, 20, :]}

    return AttributeSlices(extract)


def classify_faces(
    classifier_fn: Callable[[torch.Tensor], torch.Tensor],
    face_chips: torch.Tensor,  # [N, S, S, 3]
    face_indicators: torch.Tensor,  # [N] bool
    slices: AttributeSlices,
    fill_value: float = -1.0,
) -> dict[str, AttributeOutput]:
    raw = classifier_fn(face_chips).float()
    valid = face_indicators
    out: dict[str, AttributeOutput] = {}
    for name, logits in slices.extract(raw).items():
        probs = torch.softmax(logits, dim=-1)
        preds = torch.argmax(probs, dim=-1).to(torch.int32)
        out[name] = AttributeOutput(
            preds=torch.where(valid, preds, torch.tensor(int(fill_value), dtype=torch.int32, device=preds.device)),
            probs=torch.where(valid[:, None], probs, fill_value),
            logits=torch.where(valid[:, None], logits, fill_value),
        )
    return out
