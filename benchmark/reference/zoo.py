"""The guidance zoo for the benchmark's reference: the five frozen models at
their published widths (FaceDetectorNet, MobileNetV3-Large, CLIP-ViT-H/14,
DINOv2 ViT-B/14, SFNet-20) on the reference's plain modules, wired into a
`GuidanceStack` as fairdiff_torch/training/model_zoo.py wires the port's
(`clip_feature_fn`, `dino_feature_fn` copied)."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from benchmark.reference.attributes import celeba_slices
from benchmark.reference.clip_vision import CLIPVisionConfig, CLIPVisionModel
from benchmark.reference.dinov2 import DINOv2Config, DINOv2Model
from benchmark.reference.face_detector import DetectorConfig, FaceDetectorNet, make_detect_fn
from benchmark.reference.face_feats import FaceFeatsDB
from benchmark.reference.mobilenet_v3 import MobileNetV3Large
from benchmark.reference.resize import resize
from benchmark.reference.sfnet import SFNet, SFNetConfig
from benchmark.reference.stack import GuidanceStack, normalize_for_clip, normalize_for_dino


def clip_feature_fn(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """images in [-1, 1] -> unit CLIP image embeddings (fp32)."""
    size = model.config.image_size

    def fn(images: torch.Tensor) -> torch.Tensor:
        x = normalize_for_clip(images)
        x = resize(x, (x.shape[0], size, size, 3), "bilinear")
        e = model(x)["image_embeds"].float()
        return e / e.norm(dim=-1, keepdim=True).clamp_min(1e-6)

    return fn


def dino_feature_fn(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """images in [-1, 1] -> unit DINOv2 class features (fp32)."""

    def fn(images: torch.Tensor) -> torch.Tensor:
        x = normalize_for_dino(images)
        x = resize(x, (x.shape[0], 224, 224, 3), "bilinear")
        e = model(x).float()
        return e / e.norm(dim=-1, keepdim=True).clamp_min(1e-6)

    return fn


def zoo_modules(tiny: bool = False) -> dict[str, nn.Module]:
    """The five models, built on the current default device."""
    if tiny:
        return {"detector": FaceDetectorNet(DetectorConfig.tiny()), "classifier": MobileNetV3Large(80),
                "clip": CLIPVisionModel(CLIPVisionConfig.tiny()), "dino": DINOv2Model(DINOv2Config.tiny()),
                "face": SFNet(SFNetConfig.tiny())}
    return {"detector": FaceDetectorNet(DetectorConfig()), "classifier": MobileNetV3Large(80),
            "clip": CLIPVisionModel(CLIPVisionConfig.vit_h14()), "dino": DINOv2Model(DINOv2Config.vitb14()),
            "face": SFNet(SFNetConfig.sfnet20())}


def stack_of(models: dict[str, nn.Module], face_db: torch.Tensor,
             sizes: tuple[int, int, int] = (224, 112, 256)) -> GuidanceStack:
    """The exp-1 stack over `models` (`zoo_modules`) and a database of
    unit face embeddings [M, D]; `sizes` are the chip, the aligned face and
    the `img_size_small` resize."""
    det = models["detector"]
    return GuidanceStack(
        detect_fn=make_detect_fn(det, det.config),
        classify_fn=models["classifier"],
        slices=celeba_slices(),
        clip_feat_fn=clip_feature_fn(models["clip"]),
        dino_feat_fn=dino_feature_fn(models["dino"]),
        face_embed_fn=models["face"],
        face_db=FaceFeatsDB(face_db, torch.zeros(face_db.shape[0], dtype=torch.int32, device=face_db.device), {}),
        chip_size=sizes[0], aligned_size=sizes[1], img_size_small=sizes[2],
    )
