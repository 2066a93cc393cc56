"""Seeded weights, made on the device from the run's seed.

Each model's weights are one `torch.randn` over all its random parameters
(a `torch.Generator` on the device, seeded from the run's seed and the
model's name), scaled as fairdiff_torch's `init_weights` scales them:
matrices and convolution kernels N(0, 1/fan_in), embeddings N(0, 0.02^2),
norm scales 1, biases 0, then rounded to the type they are served in. The
names and shapes come from the reference's modules, built on the `meta`
device; the same seed gives the program and the reference the same values.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
from torch import nn

from benchmark.reference.lora import text_encoder_targets, unet_attention_targets

GOLDEN = 0x9E3779B97F4A7C15
LORA_UP_STD = 0.02  # `up` is nonzero (the published init zeroes it): see the configs' `assumed`


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit generator seed of (run seed, tag), stable across processes."""
    h = seed & ((1 << 64) - 1)
    for ch in tag.encode():
        h = ((h ^ ch) * GOLDEN) & ((1 << 64) - 1)
    return h >> 1


def _scale(name: str, p: torch.Tensor, embeddings: set[str]) -> Optional[float]:
    """The N(0, scale^2) of a random parameter, None for a constant one."""
    if name in embeddings or name.endswith("position_embedding"):
        return 0.02
    if p.dim() >= 2:
        return p[0].numel() ** -0.5
    return None


def seeded_weights(module: nn.Module, seed: int, tag: str, device: torch.device | str,
                   dtype: torch.dtype = torch.bfloat16) -> dict[str, torch.Tensor]:
    """{parameter name: value} of `module` (on any device; `meta` is enough)
    in `dtype` on `device`, from one draw."""
    embeddings = {f"{n}.weight" for n, m in module.named_modules() if isinstance(m, nn.Embedding)}
    params = sorted(module.named_parameters())
    scales = [_scale(n, p, embeddings) for n, p in params]
    total = sum(p.numel() for (_, p), s in zip(params, scales) if s is not None)
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, tag))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for (name, p), s in zip(params, scales):
        if s is None:
            fill = 0.0 if name.endswith("bias") else 1.0
            out[name] = torch.full(p.shape, fill, dtype=dtype, device=device)
        else:
            out[name] = (flat[off:off + p.numel()].view(p.shape) * s).to(dtype)
            off += p.numel()
    return out


@torch.no_grad()
def load_weights(module: nn.Module, weights: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy `weights` into `module`'s parameters, name by name; a name on
    one side only raises."""
    own = dict(module.named_parameters())
    if set(own) != set(weights):
        raise KeyError(f"parameters differ: {sorted(set(own) ^ set(weights))[:5]}")
    for name, p in own.items():
        p.copy_(weights[name])
    return module


def lora_tree(module: nn.Module, target: Callable[[tuple[str, ...]], bool], rank: int, seed: int, tag: str,
              device: torch.device | str) -> dict:
    """A LoRA tree (fairdiff_torch's layout: nested by module path, leaves
    `down` [d_in, r] and `up` [r, d_out], fp32) for every targeted Linear of
    `module`: down ~ N(0, 1) / rank as the port draws it, up ~ N(0,
    LORA_UP_STD^2), both from one draw."""
    linears = [(tuple(n.split(".")), m) for n, m in sorted(module.named_modules())
               if isinstance(m, nn.Linear) and target(tuple(n.split(".")))]
    total = sum(rank * (m.in_features + m.out_features) for _, m in linears)
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, tag))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    tree: dict = {}
    off = 0
    for path, m in linears:
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        n_down, n_up = m.in_features * rank, rank * m.out_features
        node["down"] = flat[off:off + n_down].view(m.in_features, rank) / rank
        node["up"] = flat[off + n_down:off + n_down + n_up].view(rank, m.out_features) * LORA_UP_STD
        off += n_down + n_up
    return tree


LORA_TARGETS = {"text_encoder": text_encoder_targets, "unet": unet_attention_targets}
