"""EMA shadows of adapter trees (a frozen copy of
fairdiff_torch/adapters/ema.py for the benchmark's reference).

torch_ema semantics as in the reference: after each optimizer step
ema = decay * ema + (1 - decay) * params (the trainer passes the ramp-in
decay min(0.996, (1 + step) / (10 + step))). The shadow is a detached copy
updated in place.
"""

from __future__ import annotations

from typing import Any

import torch

from benchmark.reference.tree import tree_leaves, tree_map


def init_ema(params: Any) -> Any:
    return tree_map(lambda p: p.detach().clone(), params)


@torch.no_grad()
def update_ema(ema: Any, params: Any, decay: float) -> None:
    for e, p in zip(tree_leaves(ema), tree_leaves(params)):
        e.mul_(decay).add_(p.detach().to(e.dtype), alpha=1.0 - decay)
