"""The real-architecture guidance stack from weight files (counterpart of
fairdiff/training/model_zoo.py).

The reference's frozen zoo wired into a `GuidanceStack`. The directory has
the JAX package's layout:

  <dir>/det_10g.onnx             insightface SCRFD detector: not read yet
                                 (the ONNX bridge, ROADMAP.md queue 1) -> raises
  <dir>/detector.npz             FaceDetectorNet weights
  <dir>/classifier.npz           MobileNetV3 attribute classifier
  <dir>/clip_vision/             orbax tree (CLIP-ViT-H): not read yet
                                 (orbax loading, ROADMAP.md queue 1) -> raises
  <dir>/dinov2/                  orbax tree (DINOv2 ViT-B/14): likewise -> raises
  <dir>/face_embedder.npz        SFNet backbone [optional], its variant in
  <dir>/face_embedder_variant.txt  (default sfnet20_deprecated)
  <dir>/face_feats.pkl           CelebA face-feature database [optional]

A file the port cannot read yet raises `NotImplementedError` rather than
being skipped: a stack without it would train against another objective.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import torch
from torch import nn

from fairdiff_torch.guidance.attributes import (
    AttributeSlices,
    celeba_slices,
    fairface_gender_race_age_slices,
    fairface_gender_race_slices,
)
from fairdiff_torch.guidance.face_feats import FaceFeatsDB
from fairdiff_torch.guidance.faces import FaceDetections
from fairdiff_torch.io.adapters_io import load_adapters
from fairdiff_torch.io.from_jax import load_jax_params
from fairdiff_torch.models.face_detector import DetectorConfig, load_detector_npz, make_detect_fn
from fairdiff_torch.models.mobilenet_v3 import MobileNetV3Large
from fairdiff_torch.models.sfnet import SFNet, SFNetConfig
from fairdiff_torch.training.stack import GuidanceStack, normalize_for_clip, normalize_for_dino
from fairdiff_torch.utils.resize import resize

# what the port cannot read yet, and the ROADMAP.md item that brings it
UNREADABLE = {
    "det_10g.onnx": "the ONNX SCRFD bridge (ROADMAP.md, queue 1)",
    "clip_vision": "orbax loading of clip_vision/ (ROADMAP.md, queue 1)",
    "dinov2": "orbax loading of dinov2/ (ROADMAP.md, queue 1)",
}


def slices_for(attributes: tuple[str, ...]) -> tuple[AttributeSlices, int]:
    """The classifier head of an attribute set: (slices, logits)."""
    if attributes == ("gender",):
        return celeba_slices(), 80
    if attributes in (("gender", "race"), ("race",)):
        return fairface_gender_race_slices(), 6
    if attributes == ("gender", "race", "age"):
        return fairface_gender_race_age_slices(), 8
    raise ValueError(f"no classifier head for attributes {attributes}")


def _check_readable(path: Path) -> None:
    if path.exists():
        raise NotImplementedError(f"{path}: the port cannot read it yet; it waits for {UNREADABLE[path.name]}")


def frozen(module: nn.Module, dtype: torch.dtype, device: torch.device | str) -> nn.Module:
    return module.to(device, dtype).eval().requires_grad_(False)


def load_detector(scrfd_onnx: str | Path | None, detector_npz: str | Path | None, *,
                  dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str = "cpu") -> Callable[[torch.Tensor], FaceDetections]:
    """detect(images) from the detector weights: the first-party
    FaceDetectorNet from its `.npz`. A SCRFD `.onnx` raises until the ONNX
    bridge is ported."""
    if scrfd_onnx:
        _check_readable(Path(scrfd_onnx))
    if detector_npz:
        return make_detect_fn(load_detector_npz(detector_npz, dtype, device), DetectorConfig())
    raise FileNotFoundError("no detector weights: need a detector .npz (or, later, a SCRFD det_10g.onnx)")


def clip_feature_fn(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """images in [-1, 1] -> unit CLIP image embeddings (fp32): CLIP
    normalisation, bilinear resize to the tower's image size (224), the tower."""
    size = model.config.image_size

    def fn(images: torch.Tensor) -> torch.Tensor:
        x = normalize_for_clip(images)
        x = resize(x, (x.shape[0], size, size, 3), "bilinear")
        e = model(x)["image_embeds"].float()
        return e / e.norm(dim=-1, keepdim=True).clamp_min(1e-6)

    return fn


def dino_feature_fn(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """images in [-1, 1] -> unit DINOv2 class features (fp32): ImageNet
    normalisation, bilinear resize to the reference's 224, the model."""

    def fn(images: torch.Tensor) -> torch.Tensor:
        x = normalize_for_dino(images)
        x = resize(x, (x.shape[0], 224, 224, 3), "bilinear")
        e = model(x).float()
        return e / e.norm(dim=-1, keepdim=True).clamp_min(1e-6)

    return fn


def load_guidance_stack(directory: str | Path, attributes: tuple[str, ...], *,
                        dtype: torch.dtype = torch.bfloat16,
                        device: torch.device | str = "cpu") -> GuidanceStack:
    """The stack of a guidance directory, its frozen weights in `dtype` (bf16
    by default, the reference's half-precision inference cast)."""
    d = Path(directory)
    for name in UNREADABLE:
        _check_readable(d / name)
    slices, n_logits = slices_for(tuple(attributes))
    detect_fn = load_detector(None, d / "detector.npz" if (d / "detector.npz").exists() else None,
                              dtype=dtype, device=device)
    classifier = frozen(load_jax_params(MobileNetV3Large(n_logits), load_adapters(d / "classifier.npz")),
                        dtype, device)
    face_fn = face_db = None
    if (d / "face_embedder.npz").exists():
        # the residual ordering is not in the weights: the converter writes
        # it beside them; the reference's checkpoints are the deprecated family
        vfile = d / "face_embedder_variant.txt"
        variant = vfile.read_text().strip() if vfile.exists() else "sfnet20_deprecated"
        face_fn = frozen(load_jax_params(SFNet(SFNetConfig.for_variant(variant)),
                                         load_adapters(d / "face_embedder.npz")), dtype, device)
    if (d / "face_feats.pkl").exists():
        face_db = FaceFeatsDB.from_pickle(d / "face_feats.pkl", device)
    return GuidanceStack(detect_fn=detect_fn, classify_fn=classifier, slices=slices,
                         face_embed_fn=face_fn, face_db=face_db)
