"""Weight carry-over from the JAX package's parameter trees.

A tree is the nested dict of arrays that the JAX package's `init` and
checkpoint loaders produce (numpy arrays, or anything `np.asarray` reads).
The port's modules name their submodules after the same paths, so each
leaf maps by name:

    Dense kernel [in, out]      -> Linear.weight [out, in]
    Conv kernel HWIO            -> Conv2d.weight OIHW (a depthwise kernel,
                                   HWIO with I = 1, -> [O, 1, H, W])
    LayerNorm/GroupNorm/BN scale -> .weight     (bias -> .bias)
    Embed embedding             -> Embedding.weight
    any other leaf              -> the same name: CLIP's position_embedding
                                   and class_embedding, DINOv2's cls_token,
                                   position_embeddings and layer_scale1/2,
                                   FrozenBatchNorm's mean and var (buffers)

`jax_tree_from_module` goes the other way, to write weight files in the
JAX package's layout (a guidance directory made from seeded weights).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Iterator, Mapping

import numpy as np
import torch
from torch import nn

from fairdiff_torch.utils.tree import tree_map

_SEP = "/"


def _leaves(tree: Mapping, prefix: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def state_dict_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX parameter tree -> state dict of the port's matching module."""
    out = {}
    for path, leaf in _leaves(tree):
        *mod, name = path
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":  # ml_dtypes; torch cannot wrap it
            arr = arr.astype(np.float32)
        if name == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{_SEP.join(path)}: kernel of rank {arr.ndim}")
            name = "weight"
        elif name in ("scale", "embedding"):
            name = "weight"
        out[".".join([*mod, name])] = torch.tensor(arr)  # a copy: npz arrays are read-only
    return out


def load_jax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a JAX parameter tree into `module` (every parameter must be
    covered, and nothing else), keeping the module's device and dtype."""
    module.load_state_dict(state_dict_from_jax(tree), strict=True)
    return module


def tree_from_npz(path: str | Path) -> dict[str, Any]:
    """Read a tree saved flat as `.npz` with `/`-joined paths as keys."""
    tree: dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split(_SEP)
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def adapters_from_jax(tree: Mapping) -> dict[str, Any]:
    """A JAX adapter tree (LoRA `down` [in, r] / `up` [r, out] leaves, numpy
    or anything `np.asarray` reads) -> the same tree of fp32 tensors that
    require grad, the trainable leaves of the port's trainer. LoRA leaves
    keep the JAX orientation (`adapters.lora` merges them as JAX does)."""
    return tree_map(lambda v: torch.tensor(np.asarray(v, dtype=np.float32)).requires_grad_(), tree)


def jax_tree_from_module(module: nn.Module) -> dict[str, Any]:
    """The module's parameters and buffers as a JAX parameter tree of numpy
    fp32 arrays (the inverse of `state_dict_from_jax`)."""
    tree: dict[str, Any] = {}
    for prefix, m in module.named_modules():
        for name, t in [*m.named_parameters(recurse=False), *m.named_buffers(recurse=False)]:
            arr = t.detach().float().cpu().numpy()
            if name == "weight" and isinstance(m, nn.Linear):
                name, arr = "kernel", arr.T
            elif name == "weight" and isinstance(m, nn.Conv2d):
                name, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif name == "weight" and isinstance(m, nn.Embedding):
                name = "embedding"
            elif name == "weight":
                name = "scale"
            node = tree
            for part in prefix.split(".") if prefix else []:
                node = node.setdefault(part, {})
            node[name] = np.ascontiguousarray(arr)
    return tree
