"""Adapter loading from the flat `.npz` files the JAX package's
`fairdiff.io.adapters_io.save_adapters` writes (keys are `|`-joined tree
paths)."""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np

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
