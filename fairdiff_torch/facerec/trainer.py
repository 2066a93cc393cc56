"""Face-recognition classifier training, opensphere's IterRunner
(counterpart of fairdiff/facerec/trainer.py).

Reference (opensphere/runner.py:21-196 + train.py + builder.py): an
iteration-based trainer, backbone -> margin-head loss, gradient clipping,
SGD + MultiStepLR, periodic validation. The update is the JAX package's
optax chain, written out:

- the loss is the head's plus `0.5 * weight_decay * sum(w**2)` over every
  backbone leaf (not SGD's `weight_decay`);
- `clip_by_global_norm`: when the global norm of every trained gradient
  (backbone, `head_w`, SphereFace2's `head_b`) reaches `clip_grad_norm`,
  each is scaled by `clip_grad_norm / norm` (no epsilon, unlike
  `torch.nn.utils.clip_grad_norm_`);
- `sgd(momentum)`: a trace `m = g + momentum * m`, then `p -= lr * m`, with
  `piecewise_constant_schedule`'s lr: times `lr_decay_rate` from each
  update count >= a boundary on;
- then `head_w` is projected back onto the sphere (the reference's in-place
  normalise before every forward).

The trained leaves are exactly the JAX tree's: every entry of the
backbone's state dict, so FrozenBatchNorm's `mean` and `var` (buffers of the
module, parameters of the JAX package's) are trained and decayed too. The
backbone runs through `torch.func.functional_call` on them; the module's
own tensors are left alone.

Under a data mesh (`parallel.mesh`, one process a device) each rank runs
the backbone on its rows of the batch; the features and labels are
gathered so every rank computes the whole batch's head loss (SphereFace+'s
energy term spans the batch), each rank's loss is divided by the data
size and the gradients are summed over the data axis before the clip:
every rank makes the single-device update.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from fairdiff_torch.device import resolve_device
from fairdiff_torch.fairness import margin_heads
from fairdiff_torch.guidance.face_feats import face_embeddings
from fairdiff_torch.io.from_jax import state_dict_from_jax, jax_tree_from_module
from fairdiff_torch.models.iresnet import PReLU
from fairdiff_torch.models.layers import init_weights
from fairdiff_torch.parallel.mesh import all_sum_tree, axis_size, gather_rows, gather_rows_grad, shard_batch
from fairdiff_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class FaceRecConfig:
    head: str = "sphereface"  # any fairdiff_torch.fairness.margin_heads.HEADS key
    head_kwargs: tuple = ()
    feat_dim: int = 512
    num_classes: int = 1000
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    lr_decay_steps: tuple[int, ...] = (40000, 60000, 70000)
    lr_decay_rate: float = 0.1
    max_iters: int = 80000
    clip_grad_norm: float = 1e5
    val_interval: int = 2000
    seed: int = 0


def seed_backbone(backbone: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's flax init, drawn from `generator`: conv and dense
    kernels lecun normal, biases 0, BN scale 1, bias 0, mean 0, var 1,
    PReLU alpha 0.25."""
    with torch.no_grad():
        init_weights(backbone, generator)
        for m in backbone.modules():
            if isinstance(m, PReLU):
                m.alpha.fill_(0.25)
    return backbone


class FaceRecTrainer:
    def __init__(self, backbone: nn.Module, config: FaceRecConfig, *, device: str | torch.device | None = None,
                 mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh  # a parallel.mesh DeviceMesh, or None for one device
        self.backbone = backbone.to(self.device)
        self.cfg = config
        self.head_fn = margin_heads.HEADS[config.head]
        self.head_kwargs = dict(config.head_kwargs)

    def lr_at(self, count: int) -> float:
        """optax.piecewise_constant_schedule at update `count`, in fp32."""
        v = np.float32(self.cfg.lr)
        for boundary in sorted({int(s) for s in self.cfg.lr_decay_steps}):
            if count >= boundary:
                v = np.float32(self.cfg.lr_decay_rate) * v
        return float(v)

    def init_state(self, generator: Optional[torch.Generator] = None,
                   params: Optional[Mapping[str, Any]] = None) -> dict:
        """A fresh state. `params` (the JAX trainer's `state["params"]`:
        {"backbone": tree, "head_w": [D, C], "head_b" for SphereFace2}, numpy
        or anything `np.asarray` reads) replaces the seeded init from
        `generator`."""
        cfg = self.cfg
        if params is not None:
            backbone = {k: v.float() for k, v in state_dict_from_jax(params["backbone"]).items()}
            head_w = torch.tensor(np.asarray(params["head_w"], np.float32))
            head_b = params.get("head_b")
        else:
            generator = generator if generator is not None else torch.Generator().manual_seed(cfg.seed)
            module = seed_backbone(type(self.backbone)(self.backbone.config), generator)
            backbone = {k: v.detach().clone() for k, v in module.state_dict().items()}
            # xavier-normal head weight (reference heads)
            scale = (2.0 / (cfg.feat_dim + cfg.num_classes)) ** 0.5
            head_w = margin_heads.normalize_head_weight(
                torch.randn(cfg.feat_dim, cfg.num_classes, generator=generator) * scale)
            head_b = None
        out = {"backbone": backbone, "head_w": head_w}
        if cfg.head == "sphereface2":
            if head_b is None:
                # the bias init must use the loss's own hyperparameters
                init_keys = ("magn_type", "alpha", "r", "m", "t")
                head_b = margin_heads.sphereface2_bias_init(
                    cfg.num_classes, **{k: v for k, v in self.head_kwargs.items() if k in init_keys})
            out["head_b"] = torch.tensor(np.float32(head_b))
        missing = set(self.backbone.state_dict()) ^ set(backbone)
        if missing:
            raise ValueError(f"backbone leaves do not match the module: {sorted(missing)[:5]}")
        out = tree_map(lambda t: t.to(self.device, torch.float32).requires_grad_(), out)
        trace = tree_map(torch.zeros_like, out)
        return {"params": out, "opt": {"trace": trace, "count": 0}, "step": 0}

    def _forward(self, backbone: Mapping[str, torch.Tensor], images: torch.Tensor) -> torch.Tensor:
        return functional_call(self.backbone, dict(backbone), (images,))

    def loss(self, params: Mapping[str, Any], images: torch.Tensor, labels: torch.Tensor, n: int = 0):
        """-> (loss with weight decay, the head's loss). Under a data mesh
        `images` and `labels` are this rank's rows of a batch of `n`: the
        head's loss is the batch's, and the first value is divided by the
        data size, so its gradients summed over the ranks are the batch's."""
        feats = self._forward(params["backbone"], images)
        if self.mesh is not None:
            feats, labels = gather_rows_grad(feats, self.mesh, n), gather_rows(labels, self.mesh, n)
        wd = self.cfg.weight_decay * 0.5 * sum((w**2).sum() for w in params["backbone"].values())
        if self.cfg.head == "sphereface2":
            loss = self.head_fn(params["head_w"], params["head_b"], feats, labels, **self.head_kwargs)
        else:
            loss = self.head_fn(params["head_w"], feats, labels, **self.head_kwargs)
        return (loss + wd) / axis_size(self.mesh, "data"), loss

    def train_step(self, state: dict, images, labels) -> tuple[dict, float]:
        """One update on the batch (under a data mesh every rank passes the
        whole batch and keeps its rows)."""
        n = len(labels)
        images, labels = shard_batch(self.mesh, (images, labels))
        images = torch.as_tensor(images, device=self.device)
        labels = torch.as_tensor(labels, device=self.device).long()
        params = state["params"]
        leaves = tree_leaves(params)
        total, raw = self.loss(params, images, labels, n)
        grads = torch.autograd.grad(total, leaves)
        grads = tree_leaves(all_sum_tree(tree_unflatten(params, list(grads)), self.mesh, "data"))
        count = state["opt"]["count"]
        lr = self.lr_at(count)
        with torch.no_grad():
            g_norm = torch.sqrt(sum(g.pow(2).sum() for g in grads))
            max_norm = self.cfg.clip_grad_norm
            clip = g_norm >= max_norm
            new_params, new_trace = [], []
            for p, g, m in zip(leaves, grads, tree_leaves(state["opt"]["trace"])):
                g = torch.where(clip, g / g_norm * max_norm, g)
                m = g + self.cfg.momentum * m
                new_trace.append(m)
                new_params.append((p + m * -lr).requires_grad_())
            out = tree_unflatten(params, new_params)
            out["head_w"] = margin_heads.normalize_head_weight(out["head_w"]).requires_grad_()
        new_state = {"params": out, "opt": {"trace": tree_unflatten(params, new_trace), "count": count + 1},
                     "step": state["step"] + 1}
        return new_state, raw.item()

    def fit(
        self,
        state: dict,
        batches: Iterator[tuple[np.ndarray, np.ndarray]],
        *,
        max_iters: Optional[int] = None,
        log_every: int = 100,
        logger: Callable[[int, dict], None] = lambda s, l: None,
        val_fn: Optional[Callable[[dict], dict]] = None,
        checkpoint_cb: Optional[Callable[[dict], None]] = None,
        save_interval: int = 1,
    ) -> dict:
        """Steps until `max_iters` (the config's by default). Every
        `log_every` steps the logger gets the head's loss, the step's wall
        seconds (`step_s`, the batch fetch included, ending when the loss
        reaches the host) and the batch fetch's (`data_s`); validation every
        `val_interval` steps, `checkpoint_cb` every `save_interval`."""
        max_iters = max_iters or self.cfg.max_iters
        while state["step"] < max_iters:
            t0 = time.perf_counter()
            images, labels = next(batches)
            t_data = time.perf_counter() - t0
            state, loss = self.train_step(state, images, labels)
            if state["step"] % log_every == 0:
                logger(state["step"], {"loss": loss, "step_s": time.perf_counter() - t0, "data_s": t_data})
            if val_fn and state["step"] % self.cfg.val_interval == 0:
                logger(state["step"], val_fn(state))
            if checkpoint_cb and state["step"] % max(save_interval, 1) == 0:
                checkpoint_cb(state)
        return state

    @torch.no_grad()
    def extract_features(self, state: dict, images) -> torch.Tensor:
        """Flip-sum normalised features (test.py:30-39 / runner val)."""
        images = torch.as_tensor(images, device=self.device)
        return face_embeddings(lambda x: self._forward(state["params"]["backbone"], x), images)

    def backbone_tree(self, state: dict) -> dict:
        """The state's backbone as the JAX package's parameter tree (numpy),
        the layout `save_adapters` writes and the JAX `load_adapters` reads."""
        module = type(self.backbone)(self.backbone.config)
        module.load_state_dict({k: v.detach().cpu() for k, v in state["params"]["backbone"].items()})
        return jax_tree_from_module(module)

