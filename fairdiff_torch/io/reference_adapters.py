"""The reference implementation's exported `.pth` adapters (counterpart of
fairdiff/io/reference_adapters.py, on `torch.load` and `torch.save`).

The reference's export writes:

  text_encoder_lora[_EMA].pth  keys like text_model.encoder.layers.3.
      self_attn.q_proj.lora_linear_layer.down.weight
  unet_lora[_EMA].pth          AttnProcsLayers.state_dict() keys like
      down_blocks.0.attentions.1.transformer_blocks.0.attn2.processor.
      to_q_lora.up.weight
  prefix_embedding[_EMA].pth   token_embedding.weight [n_prefix + 1, D]

The loaders map them onto the port's adapter trees (JAX parameter paths,
`down` [in, rank] and `up` [rank, out]); torch Linear weights are [out, in],
hence the transposes. The savers are their inverses.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

_TE_KEY = re.compile(
    r"^(?:text_model\.)?encoder\.layers\.(\d+)\."
    r"(self_attn\.(?:q|k|v|out)_proj|mlp\.fc[12])"
    r"\.lora_linear_layer\.(down|up)\.weight$"
)
_UNET_BLOCK = re.compile(
    r"^(down_blocks\.(\d+)\.attentions\.(\d+)"
    r"|mid_block\.attentions\.0"
    r"|up_blocks\.(\d+)\.attentions\.(\d+))\."
    r"transformer_blocks\.(\d+)\.attn([12])\.processor\."
    r"to_(q|k|v|out)_lora\.(down|up)\.weight$"
)


def _tensor(x: Any) -> torch.Tensor:
    """fp32 CPU tensor from a tensor or array."""
    return (x if torch.is_tensor(x) else torch.from_numpy(np.array(x, np.float32))).detach().float().cpu()


def _load_sd(sd_or_path: Any) -> Mapping[str, Any]:
    if isinstance(sd_or_path, (str, Path)):
        return torch.load(sd_or_path, map_location="cpu", weights_only=True)
    return sd_or_path


def _place(tree: dict, path: list[str], leaf: torch.Tensor) -> None:
    node = tree
    for name in path[:-1]:
        node = node.setdefault(name, {})
    node[path[-1]] = leaf


def load_reference_te_lora(sd_or_path: Any) -> dict:
    """text_encoder_lora[_EMA].pth -> te_lora tree."""
    tree: dict = {}
    for key, val in _load_sd(sd_or_path).items():
        m = _TE_KEY.match(key)
        if not m:
            raise KeyError(f"unrecognised TE LoRA key: {key}")
        layer, proj, du = m.groups()
        _place(tree, [f"layers_{layer}", *proj.split("."), du], _tensor(val).T.contiguous())
    if not tree:
        raise ValueError("empty TE LoRA state dict")
    return tree


def load_reference_unet_lora(sd_or_path: Any) -> dict:
    """unet_lora[_EMA].pth (AttnProcsLayers layout) -> unet_lora tree."""
    tree: dict = {}
    for key, val in _load_sd(sd_or_path).items():
        m = _UNET_BLOCK.match(key)
        if not m:
            raise KeyError(f"unrecognised UNet LoRA key: {key}")
        block, d_i, d_j, u_i, u_j, tb, attn, proj, du = m.groups()
        if block.startswith("down_blocks"):
            node = f"down_{d_i}_attn_{d_j}"
        elif block.startswith("up_blocks"):
            node = f"up_{u_i}_attn_{u_j}"
        else:
            node = "mid_attn_0"
        path = [node, f"transformer_blocks_{tb}", f"attn{attn}", f"to_{proj}", du]
        _place(tree, path, _tensor(val).T.contiguous())
    if not tree:
        raise ValueError("empty UNet LoRA state dict")
    return tree


def load_reference_prefix(sd_or_path: Any) -> torch.Tensor:
    """prefix_embedding[_EMA].pth -> prefix table [n_prefix + 1, D]."""
    sd = _load_sd(sd_or_path)
    for key in ("token_embedding.weight", "weight"):
        if key in sd:
            return _tensor(sd[key])
    raise KeyError(f"no prefix embedding table in keys {list(sd)[:5]}")


def _walk(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def save_reference_te_lora(tree: Mapping) -> dict[str, torch.Tensor]:
    """te_lora tree -> the reference's text_encoder_lora.pth keys."""
    out = {}
    for path, val in _walk(tree):
        layer, *proj, du = path
        i = layer.removeprefix("layers_")
        out[f"text_model.encoder.layers.{i}.{'.'.join(proj)}.lora_linear_layer.{du}.weight"] = (
            _tensor(val).T.contiguous()
        )
    return out


def save_reference_unet_lora(tree: Mapping) -> dict[str, torch.Tensor]:
    """unet_lora tree -> AttnProcsLayers.state_dict() keys."""
    out = {}
    for path, val in _walk(tree):
        node, tb, attn, proj, du = path
        if node == "mid_attn_0":
            block = "mid_block.attentions.0"
        else:
            side, i, _, j = node.split("_")
            block = f"{side}_blocks.{i}.attentions.{j}"
        key = (f"{block}.transformer_blocks.{tb.removeprefix('transformer_blocks_')}"
               f".{attn}.processor.{proj}_lora.{du}.weight")
        out[key] = _tensor(val).T.contiguous()
    return out


def save_reference_prefix(table: Any) -> dict[str, torch.Tensor]:
    """prefix table -> prefix_embedding.pth's key."""
    return {"token_embedding.weight": _tensor(table)}


def load_reference_adapters(path: Any) -> tuple[str, Any]:
    """Dispatch on the key layout -> ("unet_lora" | "te_lora" | "prefix",
    tree or table)."""
    sd = _load_sd(path)
    keys = list(sd)
    if any("processor.to_" in k for k in keys):
        return "unet_lora", load_reference_unet_lora(sd)
    if any("lora_linear_layer" in k for k in keys):
        return "te_lora", load_reference_te_lora(sd)
    return "prefix", load_reference_prefix(sd)


# adapter -> (the reference's file stem, its state-dict writer)
REFERENCE_FILES = {
    "te_lora": ("text_encoder_lora", save_reference_te_lora),
    "unet_lora": ("unet_lora", save_reference_unet_lora),
    "prefix": ("prefix_embedding", save_reference_prefix),
}
