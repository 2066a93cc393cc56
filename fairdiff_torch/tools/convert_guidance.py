"""Assemble a guidance directory from the reference's torch artifacts
(counterpart of fairdiff/tools/convert_guidance.py).

The reference loads its frozen zoo piece by piece: MobileNetV3 attribute
classifiers (torchvision `.pt`), the CLIP-ViT-H vision tower (HF layout),
DINOv2 (torch.hub `.pth`), the opensphere face-recognition backbone
(`.pth`), the CelebA face-feature pickle and insightface's SCRFD `.onnx`.
This CLI converts whichever of them it is given into the layout that
`fairdiff_torch.training.model_zoo.load_guidance_stack` reads:

  python -m fairdiff_torch.tools.convert_guidance \\
      --out_dir /path/guidance \\
      --classifier_pth data/2-trained-classifiers/CelebA-MobileNetLarge.pt \\
      --clip_vision_dir /path/CLIP-ViT-H-14/ \\
      --dinov2_pth /path/dinov2_vitb14.pth \\
      --sfnet_pth data/4-opensphere_checkpoints/.../backbone_100000.pth \\
      --face_feats_pkl data/3-face-features/.../face_feats.pkl \\
      --detector_onnx /path/buffalo_l/det_10g.onnx

The classifier and the SFNet go to `.npz` as in the JAX package (with
`face_embedder_variant.txt`); CLIP-vision and DINOv2 go to the port's store
(`clip_vision.pt`, `dinov2.pt`); the `.onnx` and the pickle are copied.
Inputs not given are skipped.
"""

from __future__ import annotations

import dataclasses
import shutil
import time
from pathlib import Path

import torch

from fairdiff_torch.io.adapters_io import save_adapters
from fairdiff_torch.io.checkpoints import save_params
from fairdiff_torch.io.classifiers import convert_mobilenet_v3
from fairdiff_torch.io.feature_models import convert_clip_vision, convert_dinov2
from fairdiff_torch.models.clip_vision import CLIPVisionConfig
from fairdiff_torch.models.dinov2 import DINOv2Config
from fairdiff_torch.models.sfnet import SFNetConfig, convert_sfnet
from fairdiff_torch.tools.convert_sd import load_state_dict
from fairdiff_torch.utils import config as cfglib


@dataclasses.dataclass(frozen=True)
class GuidanceConvertConfig:
    out_dir: str = "converted-guidance"
    classifier_pth: str = ""
    clip_vision_dir: str = ""
    dinov2_pth: str = ""
    sfnet_pth: str = ""
    sfnet_variant: str = "sfnet20_deprecated"
    face_feats_pkl: str = ""
    detector_onnx: str = ""
    detector_npz: str = ""


def _torch_sd(path: str) -> dict[str, torch.Tensor]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return {k.removeprefix("module."): v for k, v in sd.items() if torch.is_tensor(v)}


def main(cfg: GuidanceConvertConfig) -> Path:
    out = Path(cfg.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    done = []
    t0 = time.perf_counter()

    if cfg.classifier_pth:
        save_adapters(out / "classifier.npz", convert_mobilenet_v3(_torch_sd(cfg.classifier_pth)))
        done.append("classifier")

    if cfg.clip_vision_dir:
        sd = load_state_dict(Path(cfg.clip_vision_dir))
        n = CLIPVisionConfig.vit_h14().num_hidden_layers
        save_params(out, {"clip_vision": convert_clip_vision(sd, n)})
        done.append("clip_vision")

    if cfg.dinov2_pth:
        n = DINOv2Config.vitb14().num_hidden_layers
        save_params(out, {"dinov2": convert_dinov2(_torch_sd(cfg.dinov2_pth), n)})
        done.append("dinov2")

    if cfg.sfnet_pth:
        sfcfg = SFNetConfig.for_variant(cfg.sfnet_variant)
        save_adapters(out / "face_embedder.npz", convert_sfnet(_torch_sd(cfg.sfnet_pth), sfcfg))
        # the weight tree is shape-identical across variants, so the loader
        # cannot infer the residual ordering: record it
        (out / "face_embedder_variant.txt").write_text(cfg.sfnet_variant)
        done.append("face_embedder")

    if cfg.face_feats_pkl:
        shutil.copyfile(cfg.face_feats_pkl, out / "face_feats.pkl")
        done.append("face_feats")

    if cfg.detector_onnx:
        # parsed and run by io.onnx_bridge at load time
        shutil.copyfile(cfg.detector_onnx, out / "det_10g.onnx")
        done.append("detector(onnx)")
    elif cfg.detector_npz:
        shutil.copyfile(cfg.detector_npz, out / "detector.npz")
        done.append("detector(npz)")

    print(f"[convert_guidance] wrote {', '.join(done) or 'nothing'} -> {out} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


if __name__ == "__main__":
    main(cfglib.cli_parse(GuidanceConvertConfig))
