"""Tensor parallelism over the mesh's "model" axis, Megatron-style
(counterpart of fairdiff/parallel/tp.py).

The same rule tables as the JAX package: the UNet's attention q/k/v and
CLIP's q/k/v projections and MLP `fc1` are split by output columns (heads),
`to_out`, `out_proj` and `fc2` by input rows. GEGLU, the convolutions, the
norms, the embeddings and the VAE stay replicated. Where XLA's partitioner
inserts the collectives in JAX, `shard_sd_modules` puts each model rank's
slice of those weights into Linear subclasses that make the two Megatron
collectives themselves:

  column split  f(x) @ W[:, cols] + b[cols], with f the identity forward
                and an all-reduce of the input's gradient backward;
  row split     g(x_local @ W[rows, :]) + b, with g an all-reduce forward
                and the identity backward (the bias added after the reduce).

(`torch.distributed.nn.functional.all_reduce` is not g: its backward
all-reduces the gradient again, so a replicated loss would get `model`
times its gradient.)

With f on every split input, every replicated tensor (the residual
stream, the context, the prefix table) gets its whole gradient on every
rank. The LoRA factors merged into a split weight see only their rank's
slice (`shard_lora`), so their gradients are partial: the trainer sums
them over the model axis once a step (GSPMD does it implicitly in JAX).

Each attention runs on its local heads (`heads // model`); the UNet's
flash attention takes them as they are. Head divisibility: SD-1.5's UNet
has 8 heads and its TE 12, so model in {1, 2, 4}.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fairdiff_torch.parallel.mesh import _reduce, axis_index, axis_size

_UNET_RULES = {
    "to_q": "col",
    "to_k": "col",
    "to_v": "col",
    "to_out": "row",
}
_TE_RULES = {
    "q_proj": "col",
    "k_proj": "col",
    "v_proj": "col",
    "out_proj": "row",
    "fc1": "col",
    "fc2": "row",
}
_RULES = {"unet": _UNET_RULES, "text_encoder": _TE_RULES}


def _spec_for(rule: str | None, leaf: str) -> str:
    """A parameter's placement: a column split shards its bias with its
    weight; a row split keeps the bias replicated (added after the sum)."""
    if rule == "col" and leaf in ("weight", "bias"):
        return "col"
    if rule == "row" and leaf == "weight":
        return "row"
    return "replicated"


def param_specs(module: nn.Module, rules: dict) -> dict[str, str]:
    """{parameter name: "col" | "row" | "replicated"} for one model."""
    out = {}
    for name, _ in module.named_parameters():
        path = name.split(".")
        out[name] = _spec_for(rules.get(path[-2]) if len(path) >= 2 else None, path[-1])
    return out


def sd_param_specs(models: dict[str, nn.Module]) -> dict[str, dict[str, str]]:
    """Specs for a StableDiffusion's {text_encoder, unet, vae} (the VAE and
    anything without rules replicated)."""
    return {k: param_specs(m, _RULES.get(k, {})) for k, m in models.items()}


def validate_heads(config, model_size: int) -> None:
    """Raise unless every sharded-attention head count divides the axis."""
    for name, heads in (
        ("unet", config.unet.attention_head_dim),
        ("text_encoder", config.text.num_attention_heads),
    ):
        if heads % model_size:
            raise ValueError(
                f"{name} has {heads} attention heads, not divisible by "
                f"model axis size {model_size}"
            )


class _CopyToModel(torch.autograd.Function):
    """f: identity forward, the gradient summed over the model axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.contiguous(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """g: the partial products summed over the model axis, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ShardedLinear(nn.Linear):
    """A Linear holding this rank's slice; `in_features` and
    `out_features` keep the full sizes (the LoRA trees are full-size)."""

    def __init__(self, lin: nn.Linear, group, size: int, index: int, split: str):
        nn.Module.__init__(self)
        self.in_features, self.out_features = lin.in_features, lin.out_features
        self.group, self.split = group, split
        axis_len = lin.out_features if split == "col" else lin.in_features
        if axis_len % size:
            raise ValueError(f"{axis_len} features do not split {size} ways")
        per = axis_len // size
        self.part = slice(index * per, (index + 1) * per)
        w = lin.weight.detach()
        w = w[self.part] if split == "col" else w[:, self.part]
        self.weight = nn.Parameter(w.contiguous(), requires_grad=False)
        b = lin.bias
        if b is not None:
            b = b.detach()[self.part] if split == "col" else b.detach()
            self.bias = nn.Parameter(b, requires_grad=False)
        else:
            self.register_parameter("bias", None)

    def shard_lora(self, down: torch.Tensor, up: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's factors of a LoRA on the full layer (`down` [in, r],
        `up` [r, out]), so (down @ up).T matches the local weight."""
        return (down, up[:, self.part]) if self.split == "col" else (down[self.part], up)


class ColumnParallelLinear(_ShardedLinear):
    def __init__(self, lin, group, size, index):
        super().__init__(lin, group, size, index, "col")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(_CopyToModel.apply(x, self.group), self.weight, self.bias)


class RowParallelLinear(_ShardedLinear):
    def __init__(self, lin, group, size, index):
        super().__init__(lin, group, size, index, "row")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _ReduceFromModel.apply(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


def _shard_module(module: nn.Module, rules: dict, group, size: int, index: int) -> None:
    for _, sub in list(module.named_modules()):
        for child_name, child in list(sub.named_children()):
            rule = rules.get(child_name)
            if rule is not None and isinstance(child, nn.Linear):
                cls = ColumnParallelLinear if rule == "col" else RowParallelLinear
                setattr(sub, child_name, cls(child, group, size, index))
        for attr in ("heads", "num_heads"):  # UNet CrossAttention / CLIP MultiHeadAttention
            if isinstance(getattr(sub, attr, None), int) and any(
                    isinstance(c, _ShardedLinear) for c in sub.children()):
                setattr(sub, attr, getattr(sub, attr) // size)


def shard_sd_modules(sd, mesh) -> None:
    """Split the text encoder's and the UNet's attention (and the TE MLP)
    over the mesh's model axis in place; nothing at model size 1."""
    size = axis_size(mesh, "model")
    if size == 1:
        return
    validate_heads(sd.config, size)
    group, index = mesh.get_group("model"), axis_index(mesh, "model")
    for key in ("text_encoder", "unet"):
        _shard_module(getattr(sd, key), _RULES[key], group, size, index)
