"""Shared building blocks, a frozen copy of fairdiff_torch/models/layers.py for
the benchmark's reference: one plain attention core (fp32 logits and
softmax, the probabilities rounded to the activation type before P.V) serves
every transformer; no kernel."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import lowp


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation (transformers' `quick_gelu`)."""
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": quick_gelu,
    "silu": F.silu,
    "relu": F.relu,
    "hardswish": F.hardswish,
}


def dot_product_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, H, D]
    v: torch.Tensor,  # [B, T, H, D]
    bias: Optional[torch.Tensor] = None,  # additive, broadcastable to [B,H,S,T]
) -> torch.Tensor:
    """Multi-head attention core -> [B, S, H, D]."""
    q, k, v = lowp.round_(q), lowp.round_(k), lowp.round_(v)
    scale = q.shape[-1] ** -0.5
    # fp32 logits from the activation-type operands (exact products, as
    # preferred_element_type=float32 in the JAX einsum)
    logits = torch.matmul(q.float().transpose(1, 2), k.float().permute(0, 2, 3, 1)) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = lowp.round_(torch.softmax(logits, dim=-1).to(q.dtype))
    return torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2)


class MultiHeadAttention(nn.Module):
    """Pre-projection MHA with separate q/k/v/out projections (HF naming)."""

    def __init__(
        self, embed_dim: int, num_heads: int, out_dim: Optional[int] = None, use_bias: bool = True,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim, bias=use_bias)
        self.k_proj = nn.Linear(embed_dim, embed_dim, bias=use_bias)
        self.v_proj = nn.Linear(embed_dim, embed_dim, bias=use_bias)
        self.out_proj = nn.Linear(embed_dim, out_dim or embed_dim, bias=use_bias)

    def forward(
        self,
        hidden: torch.Tensor,  # [B, S, C]
        context: Optional[torch.Tensor] = None,  # [B, T, Cc]
        bias: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        context = hidden if context is None else context
        B, S, C = hidden.shape
        T = context.shape[1]
        heads = self.num_heads
        q = self.q_proj(hidden).reshape(B, S, heads, -1)
        k = self.k_proj(context).reshape(B, T, heads, -1)
        v = self.v_proj(context).reshape(B, T, heads, -1)
        out = dot_product_attention(q, k, v, bias).reshape(B, S, -1)
        return self.out_proj(out)


class TransformerMLP(nn.Module):
    """fc1 -> act -> fc2 (HF naming)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, activation: str = "gelu"):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)
        self.act = ACTIVATIONS[activation]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


def make_causal_mask(seq_len: int, dtype: torch.dtype = torch.float32,
                     device: torch.device | str | None = None) -> torch.Tensor:
    """Additive causal bias [1, 1, S, S]."""
    full = torch.full((seq_len, seq_len), torch.finfo(dtype).min, dtype=dtype, device=device)
    return torch.triu(full, diagonal=1)[None, None]


def expand_padding_mask(attention_mask: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, T] {0,1} -> additive bias [B, 1, 1, T] (HF `_expand_mask`)."""
    bias = (1.0 - attention_mask.to(dtype)) * torch.finfo(dtype).min
    return bias[:, None, None, :]
