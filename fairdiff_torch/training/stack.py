"""GuidanceStack: the frozen analysis models as callables (counterpart of
fairdiff/training/stack.py).

The trainer depends only on this small callable surface, so tests and the
synthetic configuration inject oracles and `training.model_zoo` wires the
real-architecture models. Each callable closes over its own weights.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from fairdiff_torch.guidance.attributes import AttributeSlices, classify_faces
from fairdiff_torch.guidance.face_feats import FaceFeatsDB, face_embeddings
from fairdiff_torch.guidance.faces import FaceAnalysis, FaceDetections, analyze_faces
from fairdiff_torch.utils.profiling import span
from fairdiff_torch.utils.resize import resize

# the reference's CLIP and DINO preprocessing statistics
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


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
    img_size_small: int = 256  # the reference's args.img_size_small resize; 0 = none

    def analyze(
        self, images: torch.Tensor, include_semantic: bool = True, include_face_feats: bool = True
    ) -> AnalysisResult:
        """faces -> attributes -> features, batched and masked,
        differentiable in the images. Phase 4 passes include_semantic=False
        and computes CLIP/DINO features on the gradient-hooked images
        (`semantic_feats`), the reference's order. Spans: "analyze", and in
        it "faces", "attributes", "face_feats" and "semantic" (each stage
        that runs)."""
        with span("analyze"):
            with span("faces"):
                faces = analyze_faces(
                    images, self.detect_fn(images), chip_size=self.chip_size, aligned_size=self.aligned_size
                )
            with span("attributes"):
                attrs = classify_faces(self.classify_fn, faces.chips, faces.indicators, self.slices)
            face_feats = clip_feats = dino_feats = None
            if self.face_embed_fn and include_face_feats:
                with span("face_feats"):
                    face_feats = face_embeddings(self.face_embed_fn, faces.aligned)
            if include_semantic:
                with span("semantic"):
                    clip_feats, dino_feats = self.semantic_feats(images)
        return AnalysisResult(faces, attrs, clip_feats, dino_feats, face_feats)

    def semantic_feats(self, images: torch.Tensor):
        """CLIP/DINO preservation features on the images resized (bilinear,
        antialiased) to `img_size_small`, the reference's order; no resize
        when neither feature function is set."""
        if self.clip_feat_fn is None and self.dino_feat_fn is None:
            return None, None
        small = images
        if self.img_size_small and images.shape[1] != self.img_size_small:
            n, _, _, c = images.shape
            small = resize(images, (n, self.img_size_small, self.img_size_small, c), "bilinear")
        clip_feats = self.clip_feat_fn(small) if self.clip_feat_fn else None
        dino_feats = self.dino_feat_fn(small) if self.dino_feat_fn else None
        return clip_feats, dino_feats


def _normalize(images: torch.Tensor, mean, std) -> torch.Tensor:
    x = images * 0.5 + 0.5
    return (x - torch.tensor(mean, device=x.device)) / torch.tensor(std, device=x.device)


def normalize_for_clip(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> CLIP's normalisation."""
    return _normalize(images, CLIP_MEAN, CLIP_STD)


def normalize_for_dino(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> ImageNet's normalisation (DINOv2)."""
    return _normalize(images, IMAGENET_MEAN, IMAGENET_STD)
