"""The fairness-finetuning trainer, exp-1 to exp-6 (counterpart of
fairdiff/training/debias.py `DebiasTrainer`).

Per optimizer step, one prompt and N noise lanes:

  phase 1  sample with the CURRENT adapters (no grad) on the prompt with
           the soft prefix when it trains (exp-2), face-analyse, classify;
           keep the final latents and the trajectory
  phase 2  dynamic targets from the phase-1 probabilities (`target_kind`:
           binary ranks, sampled OT over 2 or 3 attributes, enumerated OT),
           uncertainty gate per attribute (host numpy, the step's own
           seeded `np.random.Generator`)
  phase 3  sample with the FROZEN model on the plain prompt -> original
           features/predictions
  phase 4  linearized (docs/LINEARIZED-PHASE4.md): dL/dx_final through
           decode + guidance + loss for each lane chunk; per-step
           cotangents gamma_t * dL/dx_final; the flat batch of single-step
           UNet VJPs over (step x lane chunk), whose context cotangents are
           summed and sent through ONE text-encoder VJP into the
           text-encoder LoRA and the prefix table
  update   finite gate -> AdamW (linear warm-up of the learning rate over
           the first `lr_warmup_steps` finite updates) -> EMA

`phase4="chain"` instead differentiates the whole grad-mode sampling chain
per lane chunk (the reference's autograd semantics); it is the golden of
the linearized path in the tests. `evaluate` generates each validation
prompt's images with the given adapters and with the frozen model on the
same noises and logs their bias metrics and annotated grids; `fit` runs the
steps in the JAX trainer's prompt order (replayed on resume), logs each
step, evaluates the adapters and their EMA every `eval_interval` steps and
hands each state to a checkpoint callback. There is no counterpart of the
JAX trainer's jit programs or AOT warm-up.

Under a ("data", "model") mesh (`parallel.mesh`, one process a device) the
step is the single-device step: each data rank draws the global noise bank
and keeps its `local_slice` of the lanes; the frozen text encoder and UNet
are split over the model axis (`parallel.tp`); the phase-1 probabilities
are gathered so every rank solves the same targets on the host and keeps
its rows (the reference's `customized_all_gather`); phase 4 runs on the
local lanes in micro-batches of at most `train_micro_batch`, each loss
scaled so the summed gradients equal the single-device step's; the LoRA
gradients are summed over the model axis, every gradient over the data
axis, and each rank makes the same AdamW update. Losses and logged
metrics are global means. Evaluation runs the whole validation batch on
every rank.

Deliberate departures: the context cotangent is summed in fp32 (the JAX
program sums it in the text encoder's dtype, bf16 at SD-1.5 width); the
step's noises and step count, and the evaluation noises, come from
`utils.rng` torch generators unless passed in; the prefix rows are drawn
with a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
import shutil
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from fairdiff_torch import ops
from fairdiff_torch.adapters import lora as lora_lib
from fairdiff_torch.adapters import prefix as prefix_lib
from fairdiff_torch.adapters.ema import init_ema, update_ema
from fairdiff_torch.fairness import losses as loss_lib
from fairdiff_torch.fairness import targets as targets_lib
from fairdiff_torch.fairness import weights as weights_lib
from fairdiff_torch.parallel import tp as tp_lib
from fairdiff_torch.parallel.mesh import all_sum_tree, axis_size, data_slice, gather_rows, is_main
from fairdiff_torch.sampling import dpm_solver as dpm
from fairdiff_torch.sampling.pipeline import StableDiffusion
from fairdiff_torch.training import metrics as metrics_lib
from fairdiff_torch.training.stack import GuidanceStack
from fairdiff_torch.utils import grids as grids_lib
from fairdiff_torch.utils import rng as rng_lib
from fairdiff_torch.utils.profiling import PhaseTimers, span
from fairdiff_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class DebiasConfig:
    """The JAX `DebiasConfig`: the same fields, defaults and order."""

    # which adapters train (exp-2 trains the prefix instead of the LoRA)
    train_text_encoder: bool = True
    train_unet: bool = False
    train_prefix: bool = False
    num_prefix_tokens: int = 5
    lora_rank: int = 50
    # attributes and targets: "binary" (exp-1/2), "ot2" (exp-3/5), "ot3"
    # (exp-4), "enum" (exp-6)
    attributes: tuple[str, ...] = ("gender",)
    target_kind: str = "binary"
    target_ratio: float = 0.5
    uncertainty_thresholds: tuple[float, ...] = (0.2,)
    # OT draws a step: ot_num_samples if set, else ot_samples_per_shard
    # times the data shards (one here)
    ot_samples_per_shard: int = 100
    ot_num_samples: int = 0
    learning_rate: float = 5e-5
    weight_decay: float = 1e-2
    lr_warmup_steps: int = 0
    max_train_steps: int = 10000
    train_images_per_prompt: int = 24  # lanes per step
    train_micro_batch: int = 4  # lanes per phase-4 chunk
    steps_low: int = 19
    steps_high: int = 23
    guidance_scale: float = 7.5
    weight_loss_img: float = 8.0
    weight_loss_face: float = 1.0
    factor1: tuple[float, ...] = (0.2,)
    factor2: tuple[float, ...] = (0.1,)
    face_confidence_level: float = 0.9
    no_face_img_weight_one: bool = True  # False: lanes without a face get min(factor1)
    face_search_all_lanes: bool = False  # True: face realism on every face lane
    ema_decay: float = 0.996
    # evaluation (`fit`; 0 disables it)
    eval_interval: int = 200
    eval_denoising_steps: int = 25
    val_images_per_prompt: int = 8
    seed: int = 42
    output_dir: str = "outputs/debias"

    def factor_dict(self, which: str) -> dict[str, float]:
        return dict(zip(self.attributes, self.factor1 if which == "f1" else self.factor2))


@dataclasses.dataclass
class DebiasState:
    adapters: dict  # {"prefix": [P, d], "te_lora": tree, "unet_lora": tree}: fp32 leaves that require grad
    opt: torch.optim.Optimizer
    ema: dict
    step: int
    updates: int = 0  # finite updates applied: the learning-rate schedule's count


def match_len(uncond_ids: torch.Tensor, cond_ids: torch.Tensor) -> torch.Tensor:
    """Pad (with its last column) or cut the unconditional ids to the
    conditional length, as the reference tokenizes uncond at the cond length."""
    diff = cond_ids.shape[1] - uncond_ids.shape[1]
    if diff <= 0:
        return uncond_ids[:, : cond_ids.shape[1]]
    return torch.cat([uncond_ids, uncond_ids[:, -1:].expand(-1, diff)], dim=1)


def _global_norm(tensors: list[torch.Tensor]) -> float:
    return float(torch.sqrt(sum((t.detach().float() ** 2).sum() for t in tensors)))


def init_adapters(cfg: DebiasConfig, text_encoder: torch.nn.Module, unet: torch.nn.Module,
                  seed: int) -> dict:
    """Fresh adapters from `seed`: the LoRAs that train (down ~ N(0,1)/rank,
    up = 0), then the prefix table (rows of the frozen token table), all from
    one generator. Only the LoRAs' shapes are read from the modules, so
    modules on the `meta` device give the shapes of a checkpoint."""
    g = torch.Generator().manual_seed(seed)
    adapters: dict[str, Any] = {}
    if cfg.train_unet:
        adapters["unet_lora"] = lora_lib.init_lora(unet, lora_lib.unet_attention_targets, cfg.lora_rank, g)
    if cfg.train_text_encoder:
        adapters["te_lora"] = lora_lib.init_lora(
            text_encoder, lora_lib.text_encoder_targets, cfg.lora_rank, g
        )
    if cfg.train_prefix:
        adapters["prefix"] = prefix_lib.init_prefix(
            text_encoder.token_embedding.weight, cfg.num_prefix_tokens, g
        )
    return adapters


def new_state(cfg: DebiasConfig, adapters: dict, device: torch.device) -> DebiasState:
    """Step 0 of training `adapters` on `device`: fp32 leaves that require
    grad, their AdamW and their EMA."""
    adapters = tree_map(lambda x: x.detach().to(device, torch.float32).clone().requires_grad_(), adapters)
    opt = torch.optim.AdamW(
        tree_leaves(adapters), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=cfg.weight_decay,
    )
    return DebiasState(adapters, opt, init_ema(adapters), 0)


def pair_signature(unet: torch.nn.Module, rows: int, traj: torch.Tensor, context: torch.Tensor,
                   key_mask: Optional[torch.Tensor], weights: dict[str, torch.Tensor],
                   guidance_scale: float) -> tuple:
    """What a pair VJP's CUDA graph is captured for: the lanes a chunk, the
    latent shape, the context's shape, whether there is a key mask, the
    merged UNet LoRA weights' names and shapes, the dtypes, the UNet's flash
    backward and remat, and the guidance scale (a constant of the captured
    surrogate)."""
    return (rows, tuple(traj.shape[2:]), tuple(context.shape), key_mask is not None,
            tuple((k, tuple(w.shape)) for k, w in weights.items()),
            (traj.dtype, context.dtype, unet.conv_in.weight.dtype), unet.flash_bwd, unet.remat, guidance_scale)


class PairGraph:
    """A pair VJP (`DebiasTrainer._pair_vjp`) as a CUDA graph over static
    tensors: a lane chunk's latents `x` and cotangent `cot`, the timestep
    `t` (0-d, on the device), the context leaf and key mask, the merged UNet
    LoRA weight leaves and the fp32 accumulators. `load_step` copies in a
    step's context and weights and zeroes the accumulators; `run` copies in
    a pair's latents, cotangent and timestep, captures the graph at its
    first call and replays it after. `launches` holds the kernel launches
    of one replay, counted in the warm-up and added to the op wrappers'
    counters at each replay (a replay calls no wrapper)."""

    def __init__(self, x: torch.Tensor, cot: torch.Tensor, context: torch.Tensor,
                 key_mask: Optional[torch.Tensor], weights: dict[str, torch.Tensor]):
        static = lambda v, **kw: torch.empty(v.shape, dtype=v.dtype, device=v.device, **kw)  # noqa: E731
        self.x, self.cot = static(x), static(cot)
        self.t = torch.zeros((), dtype=torch.long, device=x.device)
        self.ctx = static(context, requires_grad=True)
        self.key_mask = None if key_mask is None else static(key_mask)
        self.weights = {k: static(w, requires_grad=True) for k, w in weights.items()}
        self.acc_c = torch.zeros(context.shape, dtype=torch.float32, device=context.device)
        self.acc_w = [torch.zeros(w.shape, dtype=torch.float32, device=w.device) for w in weights.values()]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: dict[str, int] = {}

    @torch.no_grad()
    def load_step(self, context: torch.Tensor, key_mask: Optional[torch.Tensor],
                  weights: dict[str, torch.Tensor]) -> None:
        self.ctx.copy_(context)
        if key_mask is not None:
            self.key_mask.copy_(key_mask)
        for k, w in weights.items():
            self.weights[k].copy_(w)
        self.acc_c.zero_()
        for a in self.acc_w:
            a.zero_()

    def run(self, body: Callable, x: torch.Tensor, t: int, cot: torch.Tensor) -> None:
        """One pair VJP through `body` (`_pair_vjp`). The first call warms up
        on a side stream (cuBLAS, cuDNN, the autograd engine and the
        kernels' attributes), which adds this pair's cotangents, then
        captures the graph (which adds nothing); later calls replay it.
        Spans: "graph_capture" or "graph_replay"."""
        with torch.no_grad():
            self.x.copy_(x)
            self.cot.copy_(cot)
            self.t.fill_(t)
        if self.graph is not None:
            with span("graph_replay"):
                self.graph.replay()
            ops.add_launches(self.launches)
            return
        args = (self.x, self.t, self.cot, self.ctx, self.key_mask, self.weights, self.acc_c, self.acc_w)
        with span("graph_capture"):
            side = torch.cuda.Stream(self.x.device)
            side.wait_stream(torch.cuda.current_stream())
            before = ops.launch_counts()
            with torch.cuda.stream(side):
                body(*args)
            self.launches = {k: n - before[k] for k, n in ops.launch_counts().items()}
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                body(*args)
            self.graph = graph


class DebiasTrainer:
    def __init__(
        self,
        sd: StableDiffusion,
        guidance: GuidanceStack,
        config: DebiasConfig,
        *,
        mesh=None,
    ):
        if getattr(getattr(sd, "config", None), "text_2", None) is not None:
            # phase 4's pair VJPs and their graphs carry no added conditioning yet
            raise NotImplementedError("the debiasing trainer runs SD-1.5; SDXL generates only")
        self.sd = sd
        self.guidance = guidance
        self.cfg = config
        self.mesh = mesh  # a parallel.mesh DeviceMesh, or None for one device
        tp_lib.shard_sd_modules(sd, mesh)
        self.device = sd.device
        self.timers = PhaseTimers(sd.device)
        # `fit` hands it (step, logs) for each step and evaluation
        self.logger: Callable[[int, dict], None] = lambda step, logs: None
        # the frozen model's eval grid of each (seed, prompt label): it
        # depends on nothing else, so later evaluations copy the file
        self._ori_grid_cache: dict[tuple[int, str], Path] = {}
        # inspection hooks for tests: the last step's grads and targets
        self._last_grads: Optional[dict] = None
        self._last_targets: Optional[dict] = None
        # phase 4b's pair VJP as a CUDA graph, one for each `pair_signature`
        self._pair_graphs: dict[tuple, PairGraph] = {}

    @property
    def _graph_pairs(self) -> bool:
        """Whether the pair VJPs replay CUDA graphs: on a CUDA device, where
        the UNet is whole (a UNet split over the model axis runs collectives
        inside its forward)."""
        return self.device.type == "cuda" and axis_size(self.mesh, "model") == 1

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0, adapters: Optional[dict] = None) -> DebiasState:
        """Step 0 with fresh adapters from `seed` (`init_adapters`) or the
        given adapter tree (e.g. `io.from_jax.adapters_from_jax`)."""
        if adapters is None:
            adapters = init_adapters(self.cfg, self.sd.text_encoder, self.sd.unet, seed)
        return new_state(self.cfg, adapters, self.device)

    # ------------------------------------------------------------------
    @property
    def n_data_shards(self) -> int:
        return axis_size(self.mesh, "data")

    @property
    def ot_draws(self) -> int:
        """Total OT draws a step: 100 a device all-reduced in the reference
        (exp-3:1528-1535) -> per shard times the data shards, unless set."""
        return self.cfg.ot_num_samples or self.cfg.ot_samples_per_shard * self.n_data_shards

    def make_targets(self, probs: dict[str, np.ndarray], step_rng: np.random.Generator) -> dict[str, np.ndarray]:
        """Gated targets per attribute from the phase-1 probabilities."""
        cfg = self.cfg
        th = dict(zip(cfg.attributes, cfg.uncertainty_thresholds))
        if cfg.target_kind == "binary":
            out = {"gender": targets_lib.binary_rank_targets(probs["gender"], cfg.target_ratio)}
        elif cfg.target_kind == "ot2":
            out = dict(zip(("gender", "race"), targets_lib.sampled_ot_targets_2attr(
                probs["gender"], probs["race"], step_rng, self.ot_draws)))
        elif cfg.target_kind == "ot3":
            out = dict(zip(("gender", "race", "age"), targets_lib.sampled_ot_targets_3attr(
                probs["gender"], probs["race"], probs["age"], step_rng, self.ot_draws)))
        elif cfg.target_kind == "enum":
            out = {"race": targets_lib.enumerated_ot_targets(probs["race"])}
        else:
            raise ValueError(cfg.target_kind)
        return {a: targets_lib.gate_targets_by_uncertainty(t, th[a]) for a, t in out.items()}

    def _images_loss(self, images: torch.Tensor, targets: dict, ori: dict):
        """Composite fairness loss of decoded images (exp-1:1879-1940
        semantics): fair CE on the attribute logits, the face-region gradient
        treatment before CLIP/DINO, face realism against the original or the
        database match, dynamic weights. -> (mean loss, per-lane logs)."""
        cfg = self.cfg
        res = self.guidance.analyze(images, include_semantic=False)
        ind = res.faces.indicators
        n = images.shape[0]
        zeros = torch.zeros(n, device=images.device)

        loss_fair = zeros
        fair_valid = torch.zeros(n, dtype=torch.bool, device=images.device)
        for name in cfg.attributes:
            lf, v = loss_lib.fair_ce_loss(res.attrs[name].logits, targets[name], ind)
            loss_fair = loss_fair + lf
            fair_valid = fair_valid | v

        tg = {a: targets[a] for a in cfg.attributes}
        pred_ori = {a: ori["preds"][a] for a in cfg.attributes}
        hooked = weights_lib.face_region_grad_scale_multi(
            images, res.faces.bboxes, ori["face_bboxes"], tg, pred_ori, cfg.factor_dict("f2")
        )
        clip_feats, dino_feats = self.guidance.semantic_feats(hooked)
        loss_clip = loss_lib.cosine_loss(clip_feats, ori["clip_feats"]) if clip_feats is not None else zeros
        loss_dino = loss_lib.cosine_loss(dino_feats, ori["dino_feats"]) if dino_feats is not None else zeros

        if res.face_feats is not None:
            kept_all = ind
            face_valid = ind
            for name in cfg.attributes:
                kept_all = kept_all & (
                    (targets[name] == ori["preds"][name])
                    & (targets[name] != -1)
                    & (ori["probs_max"][name] >= cfg.face_confidence_level)
                )
                if not cfg.face_search_all_lanes:
                    face_valid = face_valid & (targets[name] != -1)
            searched = res.face_feats
            if self.guidance.face_db is not None:
                _, searched = self.guidance.face_db.semantic_search(res.face_feats.detach())
            target_embeds = torch.where(kept_all[:, None], ori["face_feats"], searched)
            loss_face = loss_lib.cosine_loss(res.face_feats, target_embeds.detach())
            loss_face = torch.where(face_valid, loss_face, 0.0)
        else:
            loss_face = zeros
            face_valid = torch.zeros(n, dtype=torch.bool, device=images.device)

        dyn_w = weights_lib.dynamic_weights_multi(
            ind, tg, pred_ori, cfg.factor_dict("f1"), no_face_weight=1.0 if cfg.no_face_img_weight_one else None
        )
        out = loss_lib.composite_loss(
            loss_fair=loss_fair, loss_clip=loss_clip, loss_dino=loss_dino, loss_face=loss_face,
            dynamic_w=dyn_w, weight_img=cfg.weight_loss_img, weight_face=cfg.weight_loss_face,
            fair_valid=fair_valid, face_valid=face_valid,
        )
        return out.total, {k: v.detach() for k, v in out.logs.items()}

    def _gen_kwargs(self, adapters: Optional[dict]) -> dict:
        if not adapters:
            return {}
        return {
            "unet_lora": adapters.get("unet_lora"),
            "te_lora": adapters.get("te_lora"),
            "prefix_table": adapters.get("prefix"),
        }

    def _prefix_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """The cond ids with the prefix's synthetic ids after BOS, when the
        prefix trains."""
        if not self.cfg.train_prefix:
            return ids
        text = self.sd.config.text
        return prefix_lib.prepend_prefix_ids(
            ids, self.cfg.num_prefix_tokens, text.vocab_size, text.max_position_embeddings
        )

    # -- phase 4 -----------------------------------------------------------
    def _final_grads(self, x_final, targets, ori, n_chunks):
        """dL/dx_final [N, ...] (summed chunk-mean losses) and per-lane logs:
        per lane chunk, the loss of decode(x_final) differentiated in the
        final latents (decode checkpointed per image)."""
        m = x_final.shape[0] // n_chunks
        grads, logs = [], []
        for j in range(n_chunks):
            sl = slice(j * m, (j + 1) * m)
            x = x_final[sl].detach().requires_grad_()
            with span("loss_vjp"), torch.enable_grad():
                images = self.sd.decode_images(x, grad_mode=True)
                loss, lg = self._images_loss(
                    images, _slice_tree(targets, sl), _slice_tree(ori, sl)
                )
                (g,) = torch.autograd.grad(loss, x)
            grads.append(g)
            logs.append(lg)
        return torch.cat(grads), {k: torch.cat([lg[k] for lg in logs]) for k in logs[0]}

    def _pair_grads(self, adapters, traj, cot, ts, cond_ids, uncond_ids, p):
        """Adapter grads from the flat (step x lane-chunk) batch of
        single-step UNet VJPs of the surrogate <cot_t, guided_eps(x_t)>. The
        adapters do not change within the batch, so the UNet LoRA is merged
        once: each VJP stops at the merged weights, and their cotangents,
        summed over the batch in fp32, go through one VJP of the merge into
        `down` and `up`. Likewise the context cotangents are summed and sent
        through one VJP of the context into the text-encoder LoRA and the
        prefix.

        Each VJP is `_pair_vjp`. On a CUDA device with a whole UNet
        (`_graph_pairs`) it replays a CUDA graph (`PairGraph`, one for each
        `pair_signature`, captured the first time the signature is seen);
        elsewhere it runs eagerly. Spans: "pair_vjp" for each VJP, with
        "graph_replay" or "graph_capture" in it on the graph route and
        "unet_forward" and "unet_backward" in it where `_pair_vjp` runs;
        "encode_prompt" and "merge_vjp"."""
        unet_lora = adapters.get("unet_lora")
        weights: dict[str, torch.Tensor] = {}
        if unet_lora is not None:
            with span("merge_lora"), torch.no_grad():
                weights = {k: w.requires_grad_() for k, w in lora_lib.apply_lora(self.sd.unet, unet_lora).items()}
        ctx_adapters = {k: adapters[k] for k in ("prefix", "te_lora") if k in adapters}
        with torch.enable_grad():
            context, key_mask, _ = self.sd.build_context(
                cond_ids, uncond_ids, p, te_lora=adapters.get("te_lora"),
                prefix_table=adapters.get("prefix"),
            )
            graph = None
            if self._graph_pairs:
                sig = pair_signature(self.sd.unet, p, traj, context, key_mask, weights, self.cfg.guidance_scale)
                graph = self._pair_graphs.get(sig)
                if graph is None:
                    graph = self._pair_graphs[sig] = PairGraph(traj[0, :p], cot[0, :p], context, key_mask, weights)
                graph.load_step(context, key_mask, weights)
                acc_c, acc_w = graph.acc_c, graph.acc_w
            else:
                ctx_leaf = context.detach().requires_grad_()
                acc_c = torch.zeros(context.shape, dtype=torch.float32, device=context.device)
                acc_w = [torch.zeros(w.shape, dtype=torch.float32, device=w.device) for w in weights.values()]
            n = traj.shape[1]
            for t_idx in range(traj.shape[0]):
                for j in range(n // p):
                    with span("pair_vjp"):
                        sl = slice(j * p, (j + 1) * p)
                        if graph is not None:
                            graph.run(self._pair_vjp, traj[t_idx, sl], int(ts[t_idx]), cot[t_idx, sl])
                        else:
                            self._pair_vjp(traj[t_idx, sl], int(ts[t_idx]), cot[t_idx, sl], ctx_leaf, key_mask,
                                           weights, acc_c, acc_w)
            grads: dict[str, Any] = {}
            with span("merge_vjp"):
                if unet_lora is not None:
                    # the merged weight is W + delta (rounded once), so its
                    # cotangent is delta's
                    deltas = lora_lib.lora_deltas(self.sd.unet, unet_lora)
                    g_unet = torch.autograd.grad(list(deltas.values()), tree_leaves(unet_lora), grad_outputs=acc_w)
                    grads["unet_lora"] = tree_unflatten(unet_lora, list(g_unet))
                if ctx_adapters:
                    g_ctx = torch.autograd.grad(
                        context, tree_leaves(ctx_adapters), grad_outputs=acc_c.to(context.dtype)
                    )
                    grads.update(tree_unflatten(ctx_adapters, list(g_ctx)))
        return grads

    def _pair_vjp(self, x, t, cot, ctx_leaf, key_mask, weights, acc_c, acc_w) -> None:
        """One pair VJP: the surrogate <cot, guided_eps(x)> of a lane chunk's
        latents `x` at timestep `t` (an int, or a 0-d device tensor)
        differentiated into the context leaf and the merged UNet LoRA weight
        leaves, its cotangents added into the fp32 accumulators."""
        gs = self.cfg.guidance_scale
        with span("unet_forward"):
            eps2 = self.sd.unet_eps(torch.cat([x, x]), t, ctx_leaf, key_mask, unet_weights=weights).float()
            eps_u, eps_c = eps2.chunk(2)
            surrogate = ((eps_u + gs * (eps_c - eps_u)) * cot).sum()
        with span("unet_backward"):
            g = torch.autograd.grad(surrogate, [ctx_leaf, *weights.values()])
        acc_c += g[0].float()
        for a, gi in zip(acc_w, g[1:]):
            a += gi

    def _chain_grads(self, adapters, noises, cond_ids, uncond_ids, n_steps, targets, ori, n_chunks, norm):
        """The golden: per lane chunk, autograd through the grad-mode chain
        (generate with grad_mode=True) and the loss; the chunk grads summed
        over `norm` (the mean of chunk grads on one device)."""
        leaves = tree_leaves(adapters)
        acc = [torch.zeros_like(x) for x in leaves]
        m = noises.shape[0] // n_chunks
        logs = []
        for j in range(n_chunks):
            sl = slice(j * m, (j + 1) * m)
            with torch.enable_grad():
                images = self.sd.generate(
                    noises[sl], cond_ids, uncond_ids, n_steps, guidance_scale=self.cfg.guidance_scale,
                    grad_mode=True, **self._gen_kwargs(adapters),
                )
                loss, lg = self._images_loss(
                    images, _slice_tree(targets, sl), _slice_tree(ori, sl)
                )
                g = torch.autograd.grad(loss, leaves, allow_unused=True)
            for a, gi in zip(acc, g):
                if gi is not None:
                    a += gi
            logs.append(lg)
        grads = tree_unflatten(adapters, [a / norm for a in acc])
        return grads, {k: torch.cat([lg[k] for lg in logs]) for k in logs[0]}

    def _reduce_grads(self, grads: dict) -> dict:
        """The LoRA gradients summed over the model axis (each model rank
        saw its slice of the split weights; the prefix's is already whole),
        then every gradient over the data axis."""
        grads = {k: all_sum_tree(v, self.mesh, "model") if k in ("unet_lora", "te_lora") else v
                 for k, v in grads.items()}
        return all_sum_tree(grads, self.mesh, "data")

    def learning_rate(self, count: int) -> float:
        """The learning rate of the `count`-th finite update (0-based):
        linear from 0 over the first `lr_warmup_steps`, then constant (the
        JAX trainer's optax schedule, whose count only finite updates
        advance)."""
        cfg = self.cfg
        if not cfg.lr_warmup_steps:
            return cfg.learning_rate
        return cfg.learning_rate * min(count, cfg.lr_warmup_steps) / cfg.lr_warmup_steps

    # ------------------------------------------------------------------
    def train_step(
        self,
        state: DebiasState,
        prompt_ids: tuple[Any, Any],  # (cond_ids, uncond_ids), each [1, S]
        *,
        noises: Optional[torch.Tensor] = None,
        n_steps: Optional[int] = None,
        phase4: str = "linear",
    ) -> tuple[DebiasState, dict]:
        """One optimizer step, recorded as the root span "train_step" keyed
        by the step. `noises` [N, h, w, 4] and `n_steps` default to the
        step's draws from `utils.rng`."""
        with span("train_step", key=state.step):
            return self._train_step(state, prompt_ids, noises, n_steps, phase4)

    def _train_step(self, state, prompt_ids, noises, n_steps, phase4):
        cfg, sd, dev = self.cfg, self.sd, self.device
        step = state.step
        n, m = cfg.train_images_per_prompt, cfg.train_micro_batch
        if n % m:
            raise ValueError(f"train_images_per_prompt {n} must be a multiple of train_micro_batch {m}")
        if n % self.n_data_shards:
            raise ValueError(f"train_images_per_prompt {n} does not split over {self.n_data_shards} data shards")
        # this rank's lanes, in chunks of m_loc; each chunk's mean loss is
        # divided by `norm`, so the gradients summed over the data axis are
        # the single-device step's mean of chunk means
        lanes = data_slice(self.mesh, n)
        n_loc = n // self.n_data_shards
        m_loc = min(m, n_loc)
        if n_loc % m_loc:
            raise ValueError(f"{n_loc} lanes a data shard must be a multiple of train_micro_batch {m}")
        n_chunks, norm = n_loc // m_loc, n // m_loc
        if n_steps is None:
            n_steps = rng_lib.sample_num_denoising_steps(cfg.seed, step, cfg.steps_low, cfg.steps_high)
        if noises is None:
            noises = rng_lib.train_noises(cfg.seed, step, sd.latent_shape(n))
        noises = torch.as_tensor(np.array(noises, np.float32) if not torch.is_tensor(noises) else noises).float().to(dev)
        noises = noises[lanes]
        cond_raw, uncond_raw = (torch.as_tensor(x).to(dev).long() for x in prompt_ids)
        # phases 1 and 4 condition on the prefixed prompt, phase 3 on the plain one
        cond_ids = self._prefix_ids(cond_raw)
        uncond_ids = match_len(uncond_raw, cond_ids)
        adapters = state.adapters
        gs = cfg.guidance_scale

        # ---- phase 1: current adapters, analyse; keep the trajectory ----
        with self.timers("phase1_sample_analyze"), torch.no_grad():
            images1, x_final, traj = sd.generate(
                noises, cond_ids, uncond_ids, n_steps, guidance_scale=gs, return_latents=True,
                **self._gen_kwargs(adapters),
            )
            res1 = self.guidance.analyze(images1, include_semantic=False, include_face_feats=False)
            del images1
        # ---- phase 3: frozen model originals ----
        with self.timers("phase3_frozen_sample"), torch.no_grad():
            images3 = sd.generate(noises, cond_raw, uncond_raw, n_steps, guidance_scale=gs)
            res3 = self.guidance.analyze(images3)
            del images3
        # ---- phase 2: dynamic targets (host) from every lane's probabilities ----
        with self.timers("phase2_targets"):
            probs_host = {a: gather_rows(res1.attrs[a].probs, self.mesh, n).cpu().numpy() for a in cfg.attributes}
            step_rng = np.random.default_rng(cfg.seed * 1_000_003 + step)
            targets_np = self.make_targets(probs_host, step_rng)
            targets_all = {a: torch.as_tensor(v, device=dev) for a, v in targets_np.items()}
            targets = {a: v[lanes] for a, v in targets_all.items()}
        self._last_targets = targets_all
        ori = {
            "face_bboxes": res3.faces.bboxes,
            "clip_feats": res3.clip_feats,
            "dino_feats": res3.dino_feats,
            "face_feats": res3.face_feats,
            "preds": {a: res3.attrs[a].preds for a in cfg.attributes},
            "probs_max": {a: res3.attrs[a].probs.amax(dim=-1) for a in cfg.attributes},
        }

        # ---- phase 4 ----
        with self.timers("phase4_backward"):
            if phase4 == "linear":
                with self.timers("phase4_loss_vjp"):
                    g_final, logs_st = self._final_grads(x_final, targets, ori, n_chunks)
                with self.timers("phase4_pair_vjp"):
                    bundle = dpm.make_step_bundle(sd.config.solver, sd.schedule, n_steps)
                    gamma = dpm.chain_eps_cotangents(bundle).to(dev)
                    cot = gamma[:, None, None, None, None] * (g_final / norm)[None]
                    grads = self._pair_grads(adapters, traj, cot, bundle.t, cond_ids, uncond_ids, m_loc)
            elif phase4 == "chain":
                grads, logs_st = self._chain_grads(
                    adapters, noises, cond_ids, uncond_ids, n_steps, targets, ori, n_chunks, norm
                )
            else:
                raise ValueError(f"phase4 must be 'linear' or 'chain', not {phase4!r}")
            grads = self._reduce_grads(grads)
        self._last_grads = grads

        # ---- update: finite gate -> AdamW -> EMA ----
        decay = min(cfg.ema_decay, (1.0 + step) / (10.0 + step))
        with self.timers("update"):
            params, grad_leaves = tree_leaves(adapters), tree_leaves(grads)
            finite = all(bool(torch.isfinite(g).all()) for g in grad_leaves)
            updates = state.updates
            if finite:  # optax.apply_if_finite: a non-finite step changes nothing
                for p_, g_ in zip(params, grad_leaves):
                    p_.grad = g_.detach()
                for group in state.opt.param_groups:
                    group["lr"] = self.learning_rate(updates)
                state.opt.step()
                updates += 1
            state.opt.zero_grad(set_to_none=True)
            update_ema(state.ema, adapters, decay)
        new_state = DebiasState(adapters, state.opt, state.ema, step + 1, updates)

        preds_host = {a: gather_rows(res1.attrs[a].preds, self.mesh, n).cpu().numpy() for a in cfg.attributes}
        logs: dict[str, Any] = {
            "num_denoising_steps": int(n_steps),
            "adapter_norm": _global_norm(params),
            "ema_norm": _global_norm(tree_leaves(state.ema)),
            "grad_norm": _global_norm(grad_leaves),
            "grads_finite": finite,
            "face_rate": float(gather_rows(res1.faces.indicators, self.mesh, n).float().mean()),
            **metrics_lib.multi_attr_metrics(probs_host, preds_host),
        }
        for k, v in logs_st.items():
            v = gather_rows(v, self.mesh, n).cpu().numpy().reshape(-1)
            v = v[v != -1] if k in ("loss_fair", "loss_face") else v
            if len(v):
                logs[f"train_{k}"] = float(v.mean())
        return new_state, logs

    # -- evaluation and the run -------------------------------------------
    def _eval_grid(self, path: Path, images: torch.Tensor, res) -> None:
        attrs = {
            a: (res.attrs[a].preds.cpu().numpy(), res.attrs[a].probs.amax(dim=-1).cpu().numpy())
            for a in self.cfg.attributes
        }
        grids_lib.plot_in_grid_multi(
            images.cpu().numpy(), path, attrs,
            face_indicators=res.faces.indicators.cpu().numpy(),
            face_bboxes=res.faces.bboxes.cpu().numpy(),
        )

    def _sample_analyze(self, adapters: Optional[dict], noises: torch.Tensor, cond_ids, uncond_ids):
        """Generate at `eval_denoising_steps` and analyse (detection and the
        attribute heads only)."""
        with torch.no_grad():
            images = self.sd.generate(
                noises, cond_ids, uncond_ids, self.cfg.eval_denoising_steps,
                guidance_scale=self.cfg.guidance_scale, **self._gen_kwargs(adapters),
            )
            return images, self.guidance.analyze(images, include_semantic=False, include_face_feats=False)

    def evaluate(
        self,
        adapters: Optional[dict],
        prompt_ids_list: list[tuple[Any, Any]],
        *,
        name: str = "main",
        step: int = 0,
        prompt_texts: Optional[list[str]] = None,
        grids_dir: Optional[str | Path] = None,
        ori_grids: bool = True,
        noises: Optional[list] = None,
    ) -> dict:
        """The reference's evaluation: per validation prompt, generate
        `val_images_per_prompt` images with `adapters` on the prompt's
        evaluation noises (`utils.rng.eval_noises`, or `noises[i]`), and log
        its bias metrics under `<metric>_<label>` beside the metrics of all
        prompts together. With `grids_dir`, write the annotated grid
        `eval_<name>_<step>_<label>_generated.jpg` and, unless `ori_grids`
        is False, the frozen model's grid on the same noises
        (`..._ori.jpg`), copied from the first evaluation that drew it."""
        cfg = self.cfg
        all_probs: dict[str, list] = {a: [] for a in cfg.attributes}
        all_preds: dict[str, list] = {a: [] for a in cfg.attributes}
        per_prompt: dict[str, float] = {}
        used_labels: set[str] = set()
        for i, (cond_ids, uncond_ids) in enumerate(prompt_ids_list):
            z = (rng_lib.eval_noises(cfg.seed, i, self.sd.latent_shape(cfg.val_images_per_prompt))
                 if noises is None else noises[i])
            z = torch.as_tensor(np.array(z, np.float32) if not torch.is_tensor(z) else z).to(self.device)
            cond_raw, uncond_raw = (torch.as_tensor(x).to(self.device).long() for x in (cond_ids, uncond_ids))
            cond = self._prefix_ids(cond_raw) if adapters else cond_raw
            images, res = self._sample_analyze(adapters, z, cond, match_len(uncond_raw, cond))
            probs_i = {a: res.attrs[a].probs.cpu().numpy() for a in cfg.attributes}
            preds_i = {a: res.attrs[a].preds.cpu().numpy() for a in cfg.attributes}
            for a in cfg.attributes:
                all_probs[a].append(probs_i[a])
                all_preds[a].append(preds_i[a])
            label = (
                prompt_texts[i] if prompt_texts and i < len(prompt_texts) else f"prompt{i}"
            ).strip().replace(" ", "_").replace("/", "_")[:60]
            # folding and truncation can give two prompts one label; the
            # later one is renamed rather than overwrite the earlier's keys
            while label in used_labels:
                label = f"{label}_p{i}"
            used_labels.add(label)
            for k, v in metrics_lib.multi_attr_metrics(probs_i, preds_i).items():
                per_prompt[f"{k}_{label}"] = v
            if grids_dir:
                base = Path(grids_dir)
                self._eval_grid(base / f"eval_{name}_{step}_{label}_generated.jpg", images, res)
                if ori_grids:
                    dst = base / f"eval_{name}_{step}_{label}_ori.jpg"
                    src = self._ori_grid_cache.get((cfg.seed, label))
                    if src is not None and src.exists():
                        if src != dst:
                            shutil.copyfile(src, dst)
                    else:
                        images_o, res_o = self._sample_analyze(None, z, cond_raw, uncond_raw)
                        self._eval_grid(dst, images_o, res_o)
                        self._ori_grid_cache[(cfg.seed, label)] = dst
        probs = {a: np.concatenate(v) for a, v in all_probs.items()}
        preds = {a: np.concatenate(v) for a, v in all_preds.items()}
        out = metrics_lib.multi_attr_metrics(probs, preds)
        out.update(per_prompt)
        return out

    def fit(
        self,
        state: DebiasState,
        train_prompt_ids: list[tuple[Any, Any]],
        val_prompt_ids: Optional[list] = None,
        max_steps: Optional[int] = None,
        checkpoint_cb: Optional[Callable[[DebiasState], None]] = None,
        val_prompt_texts: Optional[list[str]] = None,
        eval_grids: bool = True,
    ) -> DebiasState:
        """Train from `state.step` to `max_steps` (default
        `max_train_steps`). Prompts come in the JAX trainer's order, one
        permutation an epoch from `np.random.default_rng(seed + 1)`, fast-
        forwarded through the epochs a resumed state has done. Each step is
        logged with `step_time_s` and the phase times `time_<phase>_s`;
        every `eval_interval` steps the adapters, then their EMA, are
        evaluated (`eval_` and `eval_ema_` keys; grids under
        `<output_dir>/imgs`); then `checkpoint_cb(state)`."""
        cfg = self.cfg
        max_steps = max_steps or cfg.max_train_steps
        n_prompts = len(train_prompt_ids)
        order_rng = np.random.default_rng(cfg.seed + 1)
        order = order_rng.permutation(n_prompts).tolist()
        for _ in range(state.step // n_prompts):
            order = order_rng.permutation(n_prompts).tolist()
        pos = state.step % n_prompts
        while state.step < max_steps:
            if pos >= n_prompts:
                order = order_rng.permutation(n_prompts).tolist()
                pos = 0
            t0 = time.perf_counter()
            state, logs = self.train_step(state, train_prompt_ids[order[pos]])
            pos += 1
            logs["step_time_s"] = time.perf_counter() - t0
            logs.update({f"time_{k}_s": v for k, v in self.timers.last.items()})
            self.logger(state.step, logs)
            if val_prompt_ids and cfg.eval_interval > 0 and state.step % cfg.eval_interval == 0:
                # under a mesh every rank evaluates (the split model needs
                # them all) and rank 0 writes the grids
                grids_dir = Path(cfg.output_dir) / "imgs" if eval_grids and is_main() else None
                kw = dict(step=state.step, prompt_texts=val_prompt_texts, grids_dir=grids_dir)
                ev = self.evaluate(state.adapters, val_prompt_ids, name="main", **kw)
                self.logger(state.step, {f"eval_{k}": v for k, v in ev.items()})
                # the frozen model's grids are the main pass's
                ev_ema = self.evaluate(state.ema, val_prompt_ids, name="ema", ori_grids=False, **kw)
                self.logger(state.step, {f"eval_ema_{k}": v for k, v in ev_ema.items()})
            if checkpoint_cb:
                checkpoint_cb(state)
        return state


class EagerPairTrainer(DebiasTrainer):
    """A `DebiasTrainer` whose pair VJPs run eagerly on every device, as on
    the CPU: the graph route's reference, and the route whose autograd
    saves can be counted (a replay saves nothing)."""

    _graph_pairs = False


def _slice_tree(tree: Any, sl: slice) -> Any:
    return tree_map(lambda x: None if x is None else x[sl], tree)
