"""GuidanceStack: the frozen analysis models as callables (counterpart of
fairdiff/training/stack.py).

The trainer depends only on this small callable surface, so tests and the
synthetic configuration inject oracles and the real-architecture stack
(a later slice) wires models. Each callable closes over its own weights.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from fairdiff_torch.guidance.attributes import AttributeSlices, classify_faces
from fairdiff_torch.guidance.face_feats import FaceFeatsDB, face_embeddings
from fairdiff_torch.guidance.faces import FaceAnalysis, FaceDetections, analyze_faces


class AnalysisResult(NamedTuple):
    faces: FaceAnalysis
    attrs: dict  # name -> AttributeOutput
    clip_feats: Optional[torch.Tensor]
    dino_feats: Optional[torch.Tensor]
    face_feats: Optional[torch.Tensor]


@dataclasses.dataclass
class GuidanceStack:
    detect_fn: Callable[[torch.Tensor], FaceDetections]
    classify_fn: Callable[[torch.Tensor], torch.Tensor]  # chips -> raw logits
    slices: AttributeSlices
    clip_feat_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    dino_feat_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    face_embed_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    face_db: Optional[FaceFeatsDB] = None
    chip_size: int = 224
    aligned_size: int = 112

    def analyze(
        self, images: torch.Tensor, include_semantic: bool = True, include_face_feats: bool = True
    ) -> AnalysisResult:
        """faces -> attributes -> features, batched and masked,
        differentiable in the images. Phase 4 passes include_semantic=False
        and computes CLIP/DINO features on the gradient-hooked images
        (`semantic_feats`), the reference's order."""
        faces = analyze_faces(
            images, self.detect_fn(images), chip_size=self.chip_size, aligned_size=self.aligned_size
        )
        attrs = classify_faces(self.classify_fn, faces.chips, faces.indicators, self.slices)
        face_feats = (
            face_embeddings(self.face_embed_fn, faces.aligned)
            if self.face_embed_fn and include_face_feats
            else None
        )
        clip_feats = dino_feats = None
        if include_semantic:
            clip_feats, dino_feats = self.semantic_feats(images)
        return AnalysisResult(faces, attrs, clip_feats, dino_feats, face_feats)

    def semantic_feats(self, images: torch.Tensor):
        """CLIP/DINO preservation features. (The JAX stack first resizes the
        images to `img_size_small` for the real CLIP/DINO models; the
        synthetic stack sets it to 0, and the resize comes with those
        models.)"""
        clip_feats = self.clip_feat_fn(images) if self.clip_feat_fn else None
        dino_feats = self.dino_feat_fn(images) if self.dino_feat_fn else None
        return clip_feats, dino_feats
