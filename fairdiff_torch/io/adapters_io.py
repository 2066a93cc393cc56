"""Adapter `.npz` files in the JAX package's format (flat, keys are
`|`-joined tree paths; `fairdiff.io.adapters_io`), so adapters move between
the two packages as they are."""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

_SEP = "|"


def load_adapters(path: str | Path) -> dict[str, Any]:
    """-> nested dict of numpy arrays."""
    tree: dict[str, Any] = {}
    with np.load(path) as data:
        for name in data.files:
            node = tree
            parts = name.split(_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[name]
    return tree


def save_adapters(path: str | Path, tree: Any) -> None:
    """Nested dict of tensors or arrays -> `.npz` (parents created)."""
    out: dict[str, np.ndarray] = {}

    def walk(node: Any, prefix: tuple[str, ...]) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (str(k),))
        else:
            out[_SEP.join(prefix)] = (
                node.detach().float().cpu().numpy() if torch.is_tensor(node) else np.asarray(node)
            )

    walk(tree, ())
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **out)
