"""Benchmark helpers of the port (counterpart of the parts of the repo-root
bench.py that the tools use): `fill_tree` (constant-filled weights),
`build` (the exp-1 trainer's models at filled weights: SD-1.5 with the
real-architecture guidance zoo, or the tiny stack) and `GenBench` (50-step
CFG generation in bf16, in images a second).

Filled weights: every matrix-like tensor (ndim >= 2) 0 and every other one
0.02, so each layer outputs its bias and activations stay finite through
the whole network at full cost (the kernels have no value-dependent fast
path). The detector's heads are set so that every lane detects a face,
the costliest path (OT targets, realism search, masked losses all on).

GenBench prints no `vs_baseline`: bench.py's denominator is derived from
A100 and TPU numbers, not measured on this card.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

# detector output-head biases that make every anchor a face (score +4:
# sigmoid 0.98), 4-stride boxes and a well-posed 5-point pattern
EVERY_LANE_DETECTS = {"cls": 4.0, "box": 2.0, "kps": (-0.6, -0.4, 0.6, -0.4, 0.0, 0.2, -0.4, 0.8, 0.4, 0.8)}


def every_lane_detects_bias(head: str, n: int):
    """The [n] fp32 bias of detector output head `head` ("cls", "box" or
    "kps") that `EVERY_LANE_DETECTS` gives, repeated over the anchors."""
    return np.resize(np.asarray(EVERY_LANE_DETECTS[head], np.float32), n)


def fill_tree(module: nn.Module, value: float = 0.02) -> nn.Module:
    """Fill `module`'s parameters and buffers in place: ndim >= 2 -> 0,
    the rest -> `value`."""
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            if t.is_floating_point():
                t.fill_(0.0 if t.dim() >= 2 else value)
    return module


def filled_zoo_stack(device: str | torch.device = "cuda"):
    """bench.py's real-architecture zoo at filled weights, in bf16
    (FaceDetectorNet, MobileNetV3-Large, CLIP-ViT-H/14, DINOv2 ViT-B/14,
    SFNet-20), every lane detecting a face, with a seeded 1024-row face
    database."""
    from fairdiff_torch.guidance.attributes import celeba_slices
    from fairdiff_torch.guidance.face_feats import FaceFeatsDB
    from fairdiff_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
    from fairdiff_torch.models.dinov2 import DINOv2Config, DINOv2Model
    from fairdiff_torch.models.face_detector import DetectorConfig, FaceDetectorNet, make_detect_fn
    from fairdiff_torch.models.mobilenet_v3 import MobileNetV3Large
    from fairdiff_torch.models.sfnet import SFNet, SFNetConfig
    from fairdiff_torch.training.model_zoo import clip_feature_fn, dino_feature_fn, frozen
    from fairdiff_torch.training.stack import GuidanceStack

    with torch.device(device):  # build on the device: CLIP-ViT-H alone is 632M weights
        det, mnv3, clip, dino, sfnet = (frozen(fill_tree(ctor()), torch.bfloat16, device) for ctor in (
            lambda: FaceDetectorNet(DetectorConfig()), lambda: MobileNetV3Large(80),
            lambda: CLIPVisionModel(CLIPVisionConfig.vit_h14()), lambda: DINOv2Model(DINOv2Config.vitb14()),
            lambda: SFNet(SFNetConfig.sfnet20())))
    with torch.no_grad():
        for head in EVERY_LANE_DETECTS:
            bias = getattr(det, head).bias
            bias.copy_(torch.from_numpy(every_lane_detects_bias(head, bias.numel())))
    g = torch.Generator().manual_seed(8)
    db = torch.randn(1024, 512, generator=g)
    db = (db / db.norm(dim=-1, keepdim=True)).to(device)
    return GuidanceStack(
        detect_fn=make_detect_fn(det, DetectorConfig()),
        classify_fn=mnv3,
        slices=celeba_slices(),
        clip_feat_fn=clip_feature_fn(clip),
        dino_feat_fn=dino_feature_fn(dino),
        face_embed_fn=sfnet,
        face_db=FaceFeatsDB(db, torch.zeros(1024, dtype=torch.int32, device=device), {}),
        img_size_small=256,
    )


def build(quick: bool, device: Optional[str] = None, micro_batch: int = 8):
    """-> (sd, guidance, DebiasConfig) of the exp-1 trainer. `quick`: the
    tiny SD at seeded weights, the synthetic stack, 4 lanes in chunks of 2,
    2 denoising steps, rank 2. Otherwise SD-1.5 without remat (as bench.py
    builds it) and the zoo at filled weights, 19 denoising steps,
    `micro_batch` lanes a chunk."""
    from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion
    from fairdiff_torch.training.presets import exp1
    from fairdiff_torch.training.synthetic import synthetic_stack

    if quick:
        sd = StableDiffusion(SDConfig.tiny(), device=device).init_random(0)
        cfg = exp1(train_images_per_prompt=4, train_micro_batch=2, steps_low=2, steps_high=2, lora_rank=2)
        return sd, synthetic_stack(("gender",), device=sd.device), cfg
    sd = StableDiffusion(SDConfig.sd15(), device=device)
    for m in sd.models().values():
        fill_tree(m)
    return sd, filled_zoo_stack(sd.device), exp1(steps_low=19, steps_high=19, train_micro_batch=micro_batch)


class GenBench:
    """50-step DPM-Solver++ CFG generation at batch `n` in bf16 on filled
    SD-1.5 weights (batch 16 by default, as bench.py's), timed on the host
    clock around calls that end in a synchronize."""

    def __init__(self, n: int = 16, device: Optional[str] = None, steps: int = 50, sd=None):
        from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion

        self.N, self.steps = n, steps
        if sd is None:
            sd = StableDiffusion(SDConfig.sd15(), device=device)
            for m in sd.models().values():
                fill_tree(m)
        self.sd = sd
        v = sd.config.text.vocab_size
        ids = torch.full((1, sd.config.text.max_position_embeddings), v - 1, dtype=torch.long)
        ids[0, 0] = 0
        self.cond = self.uncond = ids
        g = torch.Generator().manual_seed(1)
        self.noises = torch.randn(sd.latent_shape(n), generator=g).to(sd.device)

    def _generate(self) -> torch.Tensor:
        images = self.sd.generate(self.noises, self.cond, self.uncond, self.steps)
        if images.is_cuda:
            torch.cuda.synchronize(images.device)
        return images

    def run(self, *, n_timed: int = 1, emit: bool = True) -> float:
        """Images a second over `n_timed` calls after one untimed call."""
        self._generate()
        t0 = time.perf_counter()
        for _ in range(n_timed):
            images = self._generate()
        ips = self.N * n_timed / (time.perf_counter() - t0)
        if not bool(torch.isfinite(images).all()):
            raise AssertionError("GenBench: non-finite images")
        if emit:
            print(json.dumps({"metric": "gen_images_per_sec_50step_dpm", "value": ips, "unit": "img/s",
                              "batch": self.N, "device": device_name(self.sd.device)}), flush=True)
        return ips


def device_name(device: torch.device | str) -> str:
    """The card's name and power limit from nvidia-smi (CUDA), else "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
