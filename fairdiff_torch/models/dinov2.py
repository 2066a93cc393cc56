"""DINOv2 ViT: the second image-preservation backbone (counterpart of
fairdiff/models/dinov2.py).

ViT-B/14 with LayerScale residual gains and a learned position table for a
37x37 grid (the 518-pixel training size), resized to the input's grid with
`jax.image.resize`'s antialiased Keys cubic (`utils.resize`); the forward
returns the class token after the final LayerNorm. Takes NHWC images.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from fairdiff_torch.models.layers import MultiHeadAttention, TransformerMLP
from fairdiff_torch.utils.resize import resize


@dataclasses.dataclass(frozen=True)
class DINOv2Config:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    patch_size: int = 14
    pos_embed_size: int = 37  # 518/14 grid the checkpoint was trained with
    layer_norm_eps: float = 1e-6

    @classmethod
    def vitb14(cls) -> "DINOv2Config":
        return cls()

    @classmethod
    def tiny(cls) -> "DINOv2Config":
        return cls(hidden_size=32, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4, pos_embed_size=4)


class DINOv2Layer(nn.Module):
    def __init__(self, cfg: DINOv2Config):
        super().__init__()
        c = cfg.hidden_size
        self.norm1 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.attention = MultiHeadAttention(c, cfg.num_attention_heads)
        self.layer_scale1 = nn.Parameter(torch.ones(c))
        self.norm2 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.mlp = TransformerMLP(c, cfg.intermediate_size, c, "gelu")
        self.layer_scale2 = nn.Parameter(torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.norm1(x)) * self.layer_scale1
        return x + self.mlp(self.norm2(x)) * self.layer_scale2


class DINOv2Model(nn.Module):
    """images [N, H, W, 3] (ImageNet-normalised, H and W multiples of the
    patch) -> the normed class token [N, hidden]."""

    def __init__(self, config: DINOv2Config = DINOv2Config.vitb14()):
        super().__init__()
        self.config = cfg = config
        c = cfg.hidden_size
        self.patch_embedding = nn.Conv2d(3, c, cfg.patch_size, cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
        self.position_embeddings = nn.Parameter(torch.zeros(cfg.pos_embed_size**2 + 1, c))
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layers_{i}", DINOv2Layer(cfg))
        self.norm = nn.LayerNorm(c, eps=cfg.layer_norm_eps)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dtype = self.patch_embedding.weight.dtype
        n, h, w, _ = images.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size
        patches = self.patch_embedding(images.to(dtype).permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        pos_cls, pos_grid = self.position_embeddings[:1], self.position_embeddings[1:]
        if (gh, gw) != (cfg.pos_embed_size, cfg.pos_embed_size):
            # dinov2 interpolate_pos_encoding, in fp32
            grid = pos_grid.float().reshape(cfg.pos_embed_size, cfg.pos_embed_size, -1)
            pos_grid = resize(grid, (gh, gw, grid.shape[-1]), "cubic").reshape(gh * gw, -1)
        x = torch.cat([self.cls_token.to(dtype).expand(n, 1, -1), patches], dim=1)
        x = x + torch.cat([pos_cls.float(), pos_grid.float()])[None].to(dtype)
        for i in range(cfg.num_hidden_layers):
            x = getattr(self, f"layers_{i}")(x)
        return self.norm(x)[:, 0]
