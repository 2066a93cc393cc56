"""The cell's models on both sides, from its configuration file and the
run's seed: the program's (fairdiff_torch's pipeline, zoo and stack, in
the served type) and the reference's (benchmark.reference, fp32), each
with the same seeded weights, detector heads, face database and adapters.

The detector's output heads (`cls`, `box`, `kps`) get zero weights and the
biases of fairdiff_torch.bench's `EVERY_LANE_DETECTS`: every anchor is a
confident face of one size a level, so every lane detects the same box
whatever the image, the costliest path (the masked losses and the face
search all on) with no argmax over near-ties that rounding could flip.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import weights as wlib

# detector output-head biases that make every anchor a face (score +4:
# sigmoid 0.98), 4-stride boxes and a well-posed 5-point pattern
EVERY_LANE_DETECTS = {"cls": 4.0, "box": 2.0, "kps": (-0.6, -0.4, 0.6, -0.4, 0.0, 0.2, -0.4, 0.8, 0.4, 0.8)}


def ref_sd_config(config: dict):
    from benchmark.reference.autoencoder_kl import VAEConfig
    from benchmark.reference.clip_text import CLIPTextConfig
    from benchmark.reference.sd import SDConfig
    from benchmark.reference.unet2d import UNetConfig

    if config["sd"] == "tiny":
        return SDConfig(
            text=CLIPTextConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=4, max_position_embeddings=16, eos_token_id=63),
            unet=UNetConfig(sample_size=8, block_out_channels=(32, 64, 64, 64), cross_attention_dim=32,
                            attention_head_dim=2, norm_num_groups=8),
            vae=VAEConfig(block_out_channels=(16, 16, 32, 32), norm_num_groups=8))
    return SDConfig(text=CLIPTextConfig(**config["text_encoder"]), unet=UNetConfig(**_tuples(config["unet"])),
                    vae=VAEConfig(**_tuples(config["vae"])))


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def text_shape(config: dict) -> tuple[int, int]:
    """(vocab size, prompt length) of the configuration's text encoder."""
    t = ref_sd_config(config).text
    return t.vocab_size, t.max_position_embeddings


def zoo_sizes(config: dict) -> tuple[int, int, int]:
    z = config["zoo"]
    return z["chip_size"], z["aligned_size"], z["img_size_small"]


class Weights:
    """The seeded weights of every model of the cell, named as both sides
    name them, made on `device` in `dtype` when asked for."""

    def __init__(self, config: dict, seed: int, device, dtype: torch.dtype):
        from benchmark.reference.sd import RefSD
        from benchmark.reference.zoo import zoo_modules

        self.config, self.seed, self.device, self.dtype = config, seed, device, dtype
        with torch.device("meta"):
            self.sd = RefSD(ref_sd_config(config), "meta")
            self.zoo = zoo_modules(tiny=config["zoo"]["tiny"])

    def model(self, name: str) -> dict[str, torch.Tensor]:
        module = self.sd.models()[name] if name in self.sd.models() else self.zoo[name]
        w = wlib.seeded_weights(module, self.seed, name, self.device, self.dtype)
        if name == "detector":
            for head, value in EVERY_LANE_DETECTS.items():
                w[f"{head}.weight"].zero_()
                bias = w[f"{head}.bias"]
                bias.copy_(torch.from_numpy(np.resize(np.asarray(value, np.float32), bias.numel())))
        return w

    def face_db(self) -> torch.Tensor:
        g = torch.Generator(device=self.device)
        g.manual_seed(wlib.derive_seed(self.seed, "face_db"))
        dim = self.zoo["face"].config.out_channel
        db = torch.randn(self.config["zoo"]["face_db_rows"], dim, generator=g, device=self.device)
        return db / db.norm(dim=-1, keepdim=True)

    def adapters(self) -> dict:
        """{"te_lora" or "unet_lora": tree}: the configuration's LoRA, fp32."""
        target = self.config["lora"]["target"]
        module = self.sd.models()[target]
        tree = wlib.lora_tree(module, wlib.LORA_TARGETS[target], self.config["lora"]["rank"], self.seed,
                              f"lora/{target}", self.device)
        return {{"text_encoder": "te_lora", "unet": "unet_lora"}[target]: tree}


def program_sd(config: dict, w: Weights, device):
    from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion

    sd = StableDiffusion(SDConfig.tiny() if config["sd"] == "tiny" else SDConfig.sd15(), device=str(device),
                         remat=config["remat"], flash_bwd=config["flash_bwd"])
    for name, module in sd.models().items():
        wlib.load_weights(module, w.model(name))
    return sd


def program_stack(config: dict, w: Weights, device, dtype: torch.dtype):
    from fairdiff_torch.guidance.attributes import celeba_slices
    from fairdiff_torch.guidance.face_feats import FaceFeatsDB
    from fairdiff_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
    from fairdiff_torch.models.dinov2 import DINOv2Config, DINOv2Model
    from fairdiff_torch.models.face_detector import DetectorConfig, FaceDetectorNet, make_detect_fn
    from fairdiff_torch.models.mobilenet_v3 import MobileNetV3Large
    from fairdiff_torch.models.sfnet import SFNet, SFNetConfig
    from fairdiff_torch.training.model_zoo import clip_feature_fn, dino_feature_fn
    from fairdiff_torch.training.stack import GuidanceStack

    tiny = config["zoo"]["tiny"]
    ctors = {
        "detector": lambda: FaceDetectorNet(DetectorConfig.tiny() if tiny else DetectorConfig()),
        "classifier": lambda: MobileNetV3Large(80),
        "clip": lambda: CLIPVisionModel(CLIPVisionConfig.tiny() if tiny else CLIPVisionConfig.vit_h14()),
        "dino": lambda: DINOv2Model(DINOv2Config.tiny() if tiny else DINOv2Config.vitb14()),
        "face": lambda: SFNet(SFNetConfig.tiny() if tiny else SFNetConfig.sfnet20()),
    }
    models = {}
    for name, ctor in ctors.items():
        with torch.device(device):
            m = ctor()
        models[name] = wlib.load_weights(m.to(dtype), w.model(name)).eval().requires_grad_(False)
    db = w.face_db()
    chip, aligned, small = zoo_sizes(config)
    det = models["detector"]
    return GuidanceStack(
        detect_fn=make_detect_fn(det, det.config), classify_fn=models["classifier"], slices=celeba_slices(),
        clip_feat_fn=clip_feature_fn(models["clip"]), dino_feat_fn=dino_feature_fn(models["dino"]),
        face_embed_fn=models["face"],
        face_db=FaceFeatsDB(db, torch.zeros(db.shape[0], dtype=torch.int32, device=db.device), {}),
        chip_size=chip, aligned_size=aligned, img_size_small=small,
    )


def reference_sd(config: dict, w: Weights, device):
    from benchmark.reference.sd import RefSD

    with torch.device(device):
        sd = RefSD(ref_sd_config(config), device)
    for name, module in sd.models().items():
        wlib.load_weights(module, w.model(name))
    return sd


def reference_stack(config: dict, w: Weights, device):
    from benchmark.reference.zoo import stack_of, zoo_modules

    with torch.device(device):
        models = zoo_modules(tiny=config["zoo"]["tiny"])
    for name, m in models.items():
        wlib.load_weights(m, w.model(name)).eval().requires_grad_(False)
    return stack_of(models, w.face_db(), zoo_sizes(config))
