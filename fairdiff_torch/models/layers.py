"""Shared building blocks (counterpart of fairdiff/models/layers.py).

One attention core serves every transformer: fp32 logits and softmax with
the probabilities rounded to the activation type before P.V, or the
flash-attention kernel for long-key self-attention on CUDA. Submodule names
follow the JAX parameter tree so the weight carry-over is by path.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from fairdiff_torch.ops.flash_attention import FLASH_MIN_KV, flash_attention
from fairdiff_torch.ops.group_norm import fused_group_norm_silu


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
    flash_bwd: str = "split",
) -> torch.Tensor:
    """Multi-head attention core -> [B, S, H, D]. The kernel runs where the
    JAX package routes to its flash kernel (no bias, T >= FLASH_MIN_KV) and
    the tensors are on CUDA, with the backward `flash_bwd` names (checked by
    `flash_attention`); everything else takes the plain path."""
    if bias is None and k.shape[1] >= FLASH_MIN_KV and q.is_cuda:
        return flash_attention(q, k, v, flash_bwd)
    scale = q.shape[-1] ** -0.5
    # fp32 logits from the activation-type operands (exact products, as
    # preferred_element_type=float32 in the JAX einsum)
    logits = torch.matmul(q.float().transpose(1, 2), k.float().permute(0, 2, 3, 1)) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2)


class FusedGroupNorm(nn.Module):
    """GroupNorm over the channel-last axis of [B, ..., C] with an optional
    fused SiLU (counterpart of fairdiff/models/layers.py `FusedGroupNorm`):
    `weight` and `bias` [C] kept in fp32, fp32 statistics, kernel K7 on
    CUDA. Opt-in, as in the JAX package: no model of the port uses it."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5,
                 use_silu: bool = False):
        super().__init__()
        self.num_groups, self.eps, self.use_silu = num_groups, eps, use_silu
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_group_norm_silu(
            x, self.weight.float(), self.bias.float(), self.num_groups, self.eps, self.use_silu
        )


class MultiHeadAttention(nn.Module):
    """Pre-projection MHA with separate q/k/v/out projections (HF naming)."""

    def __init__(
        self, embed_dim: int, num_heads: int, out_dim: Optional[int] = None,
        use_bias: bool = True,
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


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights in place (the stand-in for a checkpoint):
    matrices and conv kernels N(0, 1/fan_in) (lecun normal, the JAX
    package's Dense/Conv default), embeddings N(0, 0.02^2), norm scales 1,
    biases 0. Drawn on the CPU in name order, so the result does not depend
    on the module's device."""
    embeddings = {
        f"{name}.weight" for name, m in module.named_modules() if isinstance(m, nn.Embedding)
    }
    for name, p in sorted(module.named_parameters()):
        if name in embeddings or name.endswith("position_embedding"):
            value = torch.randn(p.shape, generator=generator) * 0.02
        elif p.dim() >= 2:
            value = torch.randn(p.shape, generator=generator) * p[0].numel() ** -0.5
        elif name.endswith("bias"):
            value = torch.zeros(p.shape)
        else:
            value = torch.ones(p.shape)
        p.copy_(value)
    return module


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
