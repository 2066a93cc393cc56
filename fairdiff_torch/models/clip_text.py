"""CLIP text encoder, SD-1.5's conditioning model and SDXL's two (counterpart
of fairdiff/models/clip_text.py).

Accepts precomputed `inputs_embeds` (the soft-prefix path) and pools the
output at argmax(input_ids), the rule of the CLIP checkpoint SD-1.5 ships
with (kept even where extra tokens make it point elsewhere). Besides the
final-norm output and the pooled token it returns the penultimate hidden
state (the input of the last layer, transformers' `hidden_states[-2]`,
which SDXL conditions on) and, with `projection_dim`, the pooled token
through `text_projection` (transformers' `CLIPTextModelWithProjection`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from fairdiff_torch.models.layers import (
    MultiHeadAttention,
    TransformerMLP,
    expand_padding_mask,
    make_causal_mask,
)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407
    projection_dim = None  # a field of CLIPTextProjConfig

    @classmethod
    def sd15(cls) -> "CLIPTextConfig":
        return cls()

    @classmethod
    def sdxl_2(cls) -> "CLIPTextProjConfig":
        """SDXL base 1.0's `text_encoder_2/config.json`: OpenCLIP ViT-bigG/14's
        text tower (its first, `text_encoder/`, is SD-1.5's)."""
        return CLIPTextProjConfig(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
                                  num_attention_heads=20, hidden_act="gelu", projection_dim=1280)


@dataclasses.dataclass(frozen=True)
class CLIPTextProjConfig(CLIPTextConfig):
    """transformers' `CLIPTextModelWithProjection`: a biasless
    text_projection of the pooled token."""

    projection_dim: Optional[int] = None


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.self_attn = MultiHeadAttention(c, cfg.num_attention_heads)
        self.layer_norm2 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.mlp = TransformerMLP(c, cfg.intermediate_size, c, cfg.hidden_act)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), bias=bias)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        c = config.hidden_size
        self.token_embedding = nn.Embedding(config.vocab_size, c)
        self.position_embedding = nn.Parameter(torch.zeros(config.max_position_embeddings, c))
        # names mirror the JAX tree (layers_0, layers_1, ...)
        for i in range(config.num_hidden_layers):
            self.add_module(f"layers_{i}", CLIPEncoderLayer(config))
        self.final_layer_norm = nn.LayerNorm(c, eps=config.layer_norm_eps)
        if config.projection_dim is not None:
            self.text_projection = nn.Linear(c, config.projection_dim, bias=False)

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, S] int
        attention_mask: Optional[torch.Tensor] = None,  # [B, S] {0,1}
        inputs_embeds: Optional[torch.Tensor] = None,  # [B, S, C] overrides the table
    ) -> dict[str, torch.Tensor]:
        S = input_ids.shape[1]
        if inputs_embeds is None:
            inputs_embeds = self.token_embedding(input_ids)
        x = inputs_embeds + self.position_embedding[:S].to(inputs_embeds.dtype)

        bias = make_causal_mask(S, device=x.device)
        if attention_mask is not None:
            bias = bias + expand_padding_mask(attention_mask)

        penultimate = x
        for i in range(self.config.num_hidden_layers):
            penultimate = x
            x = getattr(self, f"layers_{i}")(x, bias)
        x = self.final_layer_norm(x)

        eos_idx = input_ids.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eos_idx]
        out = {"last_hidden_state": x, "pooler_output": pooled, "penultimate_hidden_state": penultimate}
        if self.config.projection_dim is not None:
            out["text_embeds"] = self.text_projection(pooled)
        return out
