"""LoRA adapters as separate trees (a frozen copy of
fairdiff_torch/adapters/lora.py for the benchmark's reference).

A LoRA tree is nested by the JAX parameter path of each targeted Linear,
with leaves `down` [d_in, r] and `up` [r, d_out] in the JAX (Flax kernel)
orientation, so `.npz` adapters move between the two packages as they are.
`apply_lora` returns merged weights for `torch.func.functional_call`; the
module itself is not modified.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

Path = tuple[str, ...]


def unet_attention_targets(path: Path) -> bool:
    """UNet LoRA surface: every attention's q/k/v/out."""
    return any(m in path for m in ("to_q", "to_k", "to_v", "to_out"))


def text_encoder_targets(path: Path) -> bool:
    """Text-encoder LoRA surface: self_attn q/k/v/out and the MLP."""
    in_attn = "self_attn" in path and any(
        m in path for m in ("q_proj", "k_proj", "v_proj", "out_proj")
    )
    in_mlp = "mlp" in path and any(m in path for m in ("fc1", "fc2"))
    return in_attn or in_mlp


def _linears(module: nn.Module):
    for name, sub in sorted(module.named_modules()):
        if isinstance(sub, nn.Linear):
            yield tuple(name.split(".")), sub


def _tensor(x, device: torch.device) -> torch.Tensor:
    """fp32 tensor from a tensor or (possibly read-only) numpy array."""
    return (x if torch.is_tensor(x) else torch.tensor(np.asarray(x))).to(device, torch.float32)


def lora_deltas(module: nn.Module, lora: Mapping) -> dict[str, torch.Tensor]:
    """{state-dict name: (down @ up)ᵀ} in fp32, in torch's [out, in]
    orientation, for every Linear that `lora` covers (its slice of the
    delta for a tensor-parallel Linear)."""
    deltas: dict[str, torch.Tensor] = {}
    for path, lin in _linears(module):
        node: Any = lora
        for name in path:
            if not isinstance(node, Mapping) or name not in node:
                break
            node = node[name]
        else:
            if "down" not in node:
                continue
            down, up = (_tensor(node[k], lin.weight.device) for k in ("down", "up"))
            deltas[".".join(path) + ".weight"] = (down @ up).T  # JAX [in, out] -> torch [out, in]
    return deltas


def apply_lora(module: nn.Module, lora: Mapping, scale: float = 1.0) -> dict[str, torch.Tensor]:
    """{state-dict name: merged weight} for every Linear that `lora` covers.

    Merges in fp32 and rounds once to the weight's dtype: adding a delta
    already rounded to bf16 would round twice and can drop updates below
    one ulp of the weight."""
    merged: dict[str, torch.Tensor] = {}
    for name, delta in lora_deltas(module, lora).items():
        w = module.get_parameter(name)
        merged[name] = (w.float() + scale * delta).to(w.dtype)
    return merged


