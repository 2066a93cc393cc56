"""Torch-checkpoint -> parameter-tree conversion (a copy of
fairdiff/io/torch_convert.py).

The reference consumes HF/torch checkpoints everywhere (SD-1.5 components,
CLIP-ViT-H, DINOv2, MobileNetV3 classifier .pth files, the opensphere
backbone .pth). The converters remap a torch `state_dict` by name into the
JAX package's parameter-tree layout (numpy, [in, out] kernels, HWIO convs);
`io.from_jax.state_dict_from_jax` then carries a tree into the port's
modules, so a converted tree equals the JAX converter's exactly.

Conventions:
  torch Linear  weight [out,in]      -> kernel [in,out] (transpose)
  torch Conv2d  weight [O,I,kh,kw]   -> kernel [kh,kw,I,O]
  torch LN/GN/BN weight/bias         -> scale/bias
  torch Embedding weight             -> embedding
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

Tensors = Mapping[str, Any]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:  # numpy has no bfloat16; fp32 holds it exactly
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def linear(sd: Tensors, prefix: str, bias: bool = True) -> dict:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if bias and f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def conv(sd: Tensors, prefix: str, bias: bool = True) -> dict:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
    if bias and f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def norm(sd: Tensors, prefix: str) -> dict:
    return {
        "scale": _np(sd[f"{prefix}.weight"]),
        "bias": _np(sd[f"{prefix}.bias"]),
    }


def batchnorm(sd: Tensors, prefix: str) -> dict:
    """BatchNorm folded for inference: returns scale/bias/mean/var leaves."""
    return {
        "scale": _np(sd[f"{prefix}.weight"]),
        "bias": _np(sd[f"{prefix}.bias"]),
        "mean": _np(sd[f"{prefix}.running_mean"]),
        "var": _np(sd[f"{prefix}.running_var"]),
    }


def embedding(sd: Tensors, prefix: str) -> dict:
    return {"embedding": _np(sd[f"{prefix}.weight"])}


def subdict(sd: Tensors, prefix: str) -> dict[str, Any]:
    p = prefix + "."
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


# ---------------------------------------------------------------------------
# CLIP text encoder (HF transformers CLIPTextModel layout)
# ---------------------------------------------------------------------------

def convert_clip_text(sd: Tensors, num_layers: int) -> dict:
    """HF `CLIPTextModel.state_dict()` -> CLIPTextModel params."""
    if any(k.startswith("text_model.") for k in sd):
        sd = {k.removeprefix("text_model."): v for k, v in sd.items()}
    params: dict[str, Any] = {
        "token_embedding": embedding(sd, "embeddings.token_embedding"),
        "position_embedding": _np(sd["embeddings.position_embedding.weight"]),
        "final_layer_norm": norm(sd, "final_layer_norm"),
    }
    for i in range(num_layers):
        p = f"encoder.layers.{i}"
        params[f"layers_{i}"] = {
            "layer_norm1": norm(sd, f"{p}.layer_norm1"),
            "layer_norm2": norm(sd, f"{p}.layer_norm2"),
            "self_attn": {
                name: linear(sd, f"{p}.self_attn.{name}")
                for name in ("q_proj", "k_proj", "v_proj", "out_proj")
            },
            "mlp": {
                "fc1": linear(sd, f"{p}.mlp.fc1"),
                "fc2": linear(sd, f"{p}.mlp.fc2"),
            },
        }
    return params
