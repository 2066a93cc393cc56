"""Synthetic guidance oracles (counterpart of fairdiff/training/synthetic.py).

The stand-ins for the frozen guidance zoo that the JAX CLI runs when no
guidance directory is given: the detector always fires at a fixed box,
attribute logits are a differentiable function of chip statistics, features
are channel means. The trainer consumes only the guidance contract, so the
whole 4-phase step runs with no model assets.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fairdiff_torch.guidance import geometry as geo
from fairdiff_torch.guidance.attributes import AttributeSlices
from fairdiff_torch.guidance.face_feats import FaceFeatsDB
from fairdiff_torch.guidance.faces import FaceDetections
from fairdiff_torch.training.stack import GuidanceStack


def oracle_detect(images: torch.Tensor) -> FaceDetections:
    n, h = images.shape[0], images.shape[1]
    scale = h / 64.0
    dev = images.device
    lms = torch.as_tensor(((geo.ARCFACE_TEMPLATE - 56.0) * 0.3 + 32.0) * scale, device=dev)
    return FaceDetections(
        indicators=torch.ones(n, dtype=torch.bool, device=dev),
        bboxes=torch.tensor([[16.0, 16.0, 48.0, 48.0]], device=dev).mul(scale).expand(n, 4),
        landmarks=lms[None].expand(n, 5, 2),
        scores=torch.full((n,), 0.9, device=dev),
    )


def synthetic_classifier(chips: torch.Tensor) -> torch.Tensor:
    """chips -> logits in 2 + 4 + 2 class blocks (gender, race, age) driven
    by channel statistics: gender from global channel means (x5), race from
    quadrant contrasts (x12), age from channel means (x15)."""
    m = chips.mean(dim=(1, 2))  # [N, 3]
    gender = torch.stack([m[:, 0] - m[:, 1], m[:, 1] - m[:, 0]], -1) * 5.0
    h2, w2 = chips.shape[1] // 2, chips.shape[2] // 2
    tl = chips[:, :h2, :w2].mean(dim=(1, 2))
    tr = chips[:, :h2, w2:].mean(dim=(1, 2))
    bl = chips[:, h2:, :w2].mean(dim=(1, 2))
    br = chips[:, h2:, w2:].mean(dim=(1, 2))
    race = torch.stack(
        [tl[:, 0] - br[:, 0], tr[:, 1] - bl[:, 1], bl[:, 2] - tr[:, 2], br[:, 0] - tl[:, 1]], -1
    ) * 12.0
    age = torch.stack([m[:, 2] - m[:, 0], m[:, 0] - m[:, 2]], -1) * 15.0
    return torch.cat([gender, race, age], dim=-1)


def synthetic_slices(attributes: tuple[str, ...]) -> AttributeSlices:
    spans = {"gender": (0, 2), "race": (2, 6), "age": (6, 8)}
    return AttributeSlices(lambda logits: {a: logits[:, spans[a][0]:spans[a][1]] for a in attributes})


def feat_fn(images: torch.Tensor) -> torch.Tensor:
    f = images.mean(dim=(1, 2))
    return f / f.norm(dim=-1, keepdim=True).clamp_min(1e-6)


def synthetic_stack(
    attributes: tuple[str, ...] = ("gender",),
    db_feats: Optional[np.ndarray] = None,
    device: torch.device | str = "cpu",
) -> GuidanceStack:
    """The synthetic stack; `db_feats` [8, 3] are the face-database rows
    (normalised here). The JAX package draws them with jax.random; by
    default the port draws its own from a seeded generator, and tests pass
    the JAX rows."""
    if db_feats is None:
        db_feats = torch.randn(8, 3, generator=torch.Generator().manual_seed(7)).numpy()
    feats = torch.tensor(np.asarray(db_feats, np.float32), device=device)
    feats = feats / feats.norm(dim=-1, keepdim=True)
    return GuidanceStack(
        detect_fn=oracle_detect,
        classify_fn=synthetic_classifier,
        slices=synthetic_slices(attributes),
        clip_feat_fn=feat_fn,
        dino_feat_fn=feat_fn,
        face_embed_fn=lambda chips: chips.mean(dim=(1, 2)),
        face_db=FaceFeatsDB(feats, torch.zeros(8, dtype=torch.int32, device=device), {}),
        chip_size=32,
        aligned_size=32,
        img_size_small=0,
    )
