"""CLIP vision tower with projection: the image-preservation loss backbone (a
frozen copy of fairdiff_torch/models/clip_vision.py for the benchmark's
reference).

CLIP-ViT-H/14 (`CLIPVisionModelWithProjection`): a patch convolution, a
class token, learned positions, pre-LayerNorm, the text model's encoder
layers without a causal mask (gelu), post-LayerNorm on the class token and
a biasless projection. 257 tokens at 224x224: under FLASH_MIN_KV, so the
attention takes the plain path, as in the JAX package. Takes NHWC images.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from benchmark.reference.clip_text import CLIPEncoderLayer, CLIPTextConfig


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 1024
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5

    @classmethod
    def vit_h14(cls) -> "CLIPVisionConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "CLIPVisionConfig":
        return cls(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                   image_size=28, patch_size=14, projection_dim=16)

    def text_view(self) -> CLIPTextConfig:
        """The encoder-layer fields as the text model's config."""
        return CLIPTextConfig(
            hidden_size=self.hidden_size, intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers, num_attention_heads=self.num_attention_heads,
            hidden_act=self.hidden_act, layer_norm_eps=self.layer_norm_eps,
        )


class CLIPVisionModel(nn.Module):
    """images [N, H, W, 3] (CLIP-normalised) -> {"image_embeds", "pooler_output"}."""

    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig.vit_h14()):
        super().__init__()
        self.config = cfg = config
        c = cfg.hidden_size
        self.patch_embedding = nn.Conv2d(3, c, cfg.patch_size, cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(c))
        self.position_embedding = nn.Parameter(torch.zeros((cfg.image_size // cfg.patch_size) ** 2 + 1, c))
        self.pre_layrnorm = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        lcfg = cfg.text_view()
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layers_{i}", CLIPEncoderLayer(lcfg))
        self.post_layernorm = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.visual_projection = nn.Linear(c, cfg.projection_dim, bias=False)

    def forward(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        dtype = self.patch_embedding.weight.dtype
        n = images.shape[0]
        patches = self.patch_embedding(images.to(dtype).permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(dtype)[None, None].expand(n, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        x = self.pre_layrnorm(x + self.position_embedding[None, : x.shape[1]].to(dtype))
        for i in range(self.config.num_hidden_layers):
            x = getattr(self, f"layers_{i}")(x, None)
        pooled = self.post_layernorm(x[:, 0])
        return {"image_embeds": self.visual_projection(pooled), "pooler_output": pooled}
