"""The real-architecture guidance stack from weight files (counterpart of
fairdiff/training/model_zoo.py).

The reference's frozen zoo wired into a `GuidanceStack`. The directory is
what `tools/convert_guidance` writes:

  <dir>/det_10g.onnx             insightface SCRFD detector, run by
                                 `io.onnx_bridge` in its stored fp32 (the primary)
  <dir>/detector.npz             FaceDetectorNet weights (the fallback, or
                                 the detector alone)
  <dir>/classifier.npz           MobileNetV3 attribute classifier
  <dir>/clip_vision.pt           CLIP-ViT-H/14 state dict [optional]
  <dir>/dinov2.pt                DINOv2 ViT-B/14 state dict [optional]
  <dir>/face_embedder.npz        SFNet backbone [optional], its variant in
  <dir>/face_embedder_variant.txt  (default sfnet20_deprecated)
  <dir>/face_feats.pkl           CelebA face-feature database [optional]

The JAX package writes CLIP-vision and DINOv2 as orbax trees,
`<dir>/clip_vision/` and `<dir>/dinov2/`. Orbax imports JAX, so such a
directory raises `NotImplementedError`, naming the port's converter, rather
than being skipped: a stack without them would train against another
objective.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Callable

import torch
from torch import nn

from fairdiff_torch.device import resolve_device
from fairdiff_torch.guidance.attributes import (
    AttributeSlices,
    celeba_slices,
    fairface_gender_race_age_slices,
    fairface_gender_race_slices,
)
from fairdiff_torch.guidance.face_feats import FaceFeatsDB
from fairdiff_torch.guidance.faces import FaceDetections, compose_detectors
from fairdiff_torch.io import checkpoints as store
from fairdiff_torch.io.adapters_io import load_adapters
from fairdiff_torch.io.from_jax import load_jax_params
from fairdiff_torch.io.onnx_bridge import load_scrfd
from fairdiff_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
from fairdiff_torch.models.dinov2 import DINOv2Config, DINOv2Model
from fairdiff_torch.models.face_detector import DetectorConfig, load_detector_npz, make_detect_fn
from fairdiff_torch.models.mobilenet_v3 import MobileNetV3Large
from fairdiff_torch.models.sfnet import SFNet, SFNetConfig
from fairdiff_torch.training.stack import GuidanceStack, normalize_for_clip, normalize_for_dino
from fairdiff_torch.utils.resize import resize

# the feature towers of the port's store, each at its published width
FEATURE_MODELS = {
    "clip_vision": lambda: CLIPVisionModel(CLIPVisionConfig.vit_h14()),
    "dinov2": lambda: DINOv2Model(DINOv2Config.vitb14()),
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


def frozen(module: nn.Module, dtype: torch.dtype, device: torch.device | str) -> nn.Module:
    return module.to(device, dtype).eval().requires_grad_(False)


def load_detector(scrfd_onnx: str | Path | None, detector_npz: str | Path | None, *,
                  dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str | None = None,
                  scrfd_input_size: tuple[int, int] = (640, 640)) -> Callable[[torch.Tensor], FaceDetections]:
    """detect(images) from the detector weights: SCRFD from its `.onnx` as
    the primary, kept in its stored fp32 whatever `dtype` is (the reference
    runs it in fp32, and its box-regression heads are precision-sensitive),
    and the first-party FaceDetectorNet from its `.npz`, in `dtype`, filling
    the lanes SCRFD misses. With one path, that detector runs alone. On CUDA
    unless `device="cpu"` is asked for (`resolve_device`)."""
    device = resolve_device(device)
    onnx_fn = net_fn = None
    if scrfd_onnx:
        detect, params = load_scrfd(str(scrfd_onnx), input_size=scrfd_input_size, device=device)
        onnx_fn = functools.partial(detect, params)
    if detector_npz:
        net_fn = make_detect_fn(load_detector_npz(detector_npz, dtype, device), DetectorConfig())
    if onnx_fn and net_fn:
        return compose_detectors(onnx_fn, net_fn)
    if onnx_fn or net_fn:
        return onnx_fn or net_fn
    raise FileNotFoundError("no detector weights: need a SCRFD det_10g.onnx (reference weights) "
                            "and/or a detector .npz")


def load_feature_model(directory: str | Path, name: str, dtype: torch.dtype,
                       device: torch.device | str) -> nn.Module:
    """CLIP-vision or DINOv2 (`name`) at its published width, built on
    `device` in `dtype`, with the weights of the port's store (strict)."""
    with torch.device(device):
        module = frozen(FEATURE_MODELS[name](), dtype, device)
    module.load_state_dict(store.load_params(directory, [name])[name], strict=True)
    return module


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
                        device: torch.device | str | None = None) -> GuidanceStack:
    """The stack of a guidance directory, its frozen weights in `dtype` (bf16
    by default, the reference's half-precision inference cast; SCRFD stays
    fp32), on CUDA unless `device="cpu"` is asked for (`resolve_device`)."""
    device = resolve_device(device)
    d = Path(directory)
    for name in FEATURE_MODELS:  # the JAX package's orbax tree raises here, before anything loads
        if (d / name).is_dir():
            store.store_path(d, name)
    slices, n_logits = slices_for(tuple(attributes))
    detect_fn = load_detector(
        (d / "det_10g.onnx") if (d / "det_10g.onnx").exists() else None,
        (d / "detector.npz") if (d / "detector.npz").exists() else None,
        dtype=dtype, device=device,
    )
    classifier = frozen(load_jax_params(MobileNetV3Large(n_logits), load_adapters(d / "classifier.npz")),
                        dtype, device)
    clip_fn = dino_fn = face_fn = face_db = None
    if (d / "clip_vision.pt").exists():
        clip_fn = clip_feature_fn(load_feature_model(d, "clip_vision", dtype, device))
    if (d / "dinov2.pt").exists():
        dino_fn = dino_feature_fn(load_feature_model(d, "dinov2", dtype, device))
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
                         clip_feat_fn=clip_fn, dino_feat_fn=dino_fn,
                         face_embed_fn=face_fn, face_db=face_db)
