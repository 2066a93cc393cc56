"""Face-recognition features and the face-feature database (counterpart of
fairdiff/guidance/face_feats.py).

- `face_embeddings`: flip-sum, L2-normalised backbone features.
- `FaceFeatsDB`: a frozen matrix of normalised face embeddings with top-1
  dot-product search, which picks realism targets for faces whose identity
  must change.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from fairdiff_torch.device import resolve_device


def face_embeddings(
    backbone_fn: Callable[[torch.Tensor], torch.Tensor],
    aligned_chips: torch.Tensor,  # [N, A, A, 3] in [-1, 1]
    *,
    flip: bool = True,
    normalize: bool = True,
) -> torch.Tensor:
    feats = backbone_fn(aligned_chips)
    if flip:
        feats = feats + backbone_fn(aligned_chips.flip(2))
    feats = feats.float()
    if normalize:
        feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return feats


class FaceFeatsDB(NamedTuple):
    feats: torch.Tensor  # [M, D] L2-normalised
    genders: torch.Tensor  # [M] int32
    extra: dict  # e.g. {"race": [M]}

    @classmethod
    def from_pickle(cls, path: str | Path, device: torch.device | str | None = None) -> "FaceFeatsDB":
        """A reference `face_feats.pkl`: (feats, genders, logits) for exp-1 or
        (feats, genders, g_logits, races, r_logits) for exp-3 and later, on
        CUDA unless `device="cpu"` is asked for (`resolve_device`)."""
        device = resolve_device(device)
        with open(path, "rb") as f:
            data = pickle.load(f)
        feats = torch.tensor(np.asarray(data[0], np.float32), device=device)
        feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        as_ids = lambda x: torch.tensor(np.asarray(x).reshape(-1).astype(np.int32), device=device)
        extra = {"race": as_ids(data[3])} if len(data) >= 5 else {}
        return cls(feats, as_ids(data[1]), extra)

    def semantic_search(self, queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-1 cosine match: queries [Q, D] -> (indices [Q], feats [Q, D])."""
        idx = torch.argmax(queries @ self.feats.T, dim=-1)
        return idx, self.feats[idx]
