"""One exp-1 optimizer step for the benchmark's reference: a frozen copy of the
arithmetic of fairdiff_torch/training/debias.py `DebiasTrainer.train_step`
(linearized phase 4, one device) on the reference's plain modules.

  phase 1  sample with the current adapters, analyse (no face features)
  phase 3  sample with the frozen model, full analysis -> the originals
  phase 2  binary rank targets of the phase-1 probabilities, gated
  phase 4  dL/dx_final through decode + guidance + loss per lane chunk;
           gamma_t * dL/dx_final as each step's cotangent; one UNet VJP a
           (step, lane) pair of the surrogate <cot_t, guided eps(x_t)>, the
           context and merged-weight cotangents summed in fp32 and sent
           through one VJP of the context and of the merge into the LoRAs
  update   finite gate -> AdamW -> EMA

The pair VJPs run `micro_batch` lanes at a time, as the port's do.

The step's discrete decisions (phase 2's ranks and gate of the phase-1
probabilities, the argmax and the confidence threshold of the phase-3
probabilities, the face database's top-1 row of each lane) flip under
rounding where two values lie within it. Given `follow` (another run's
decisions: `decisions` of its probabilities, and its search rows), the
step takes those decisions and nothing continuous of that run, so what it
is compared on is the arithmetic; the decisions it would have taken itself
are returned beside.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from benchmark.reference import dpm_solver as dpm
from benchmark.reference import lora as lora_lib
from benchmark.reference import losses as loss_lib
from benchmark.reference import targets as targets_lib
from benchmark.reference import weights as weights_lib
from benchmark.reference.ema import update_ema
from benchmark.reference.sd import RefSD
from benchmark.reference.stack import GuidanceStack
from benchmark.reference.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The exp-1 fields the step reads (`DebiasConfig`'s names and values)."""

    lanes: int = 12
    micro_batch: int = 4
    target_ratio: float = 0.5
    uncertainty_threshold: float = 0.2
    guidance_scale: float = 7.5
    weight_loss_img: float = 8.0
    weight_loss_face: float = 1.0
    factor1: float = 0.2
    factor2: float = 0.1
    face_confidence_level: float = 0.9
    ema_decay: float = 0.996


def images_loss(stack: GuidanceStack, cfg: StepConfig, images, targets, ori, rows=None):
    """The composite fairness loss of decoded images -> (mean loss, per-lane
    loss, face features). `rows` replaces the database search's top-1 rows."""
    res = stack.analyze(images, include_semantic=False)
    ind = res.faces.indicators
    t, p_ori = targets["gender"], ori["preds"]["gender"]
    loss_fair, fair_valid = loss_lib.fair_ce_loss(res.attrs["gender"].logits, t, ind)
    hooked = weights_lib.face_region_grad_scale_multi(
        images, res.faces.bboxes, ori["face_bboxes"], {"gender": t}, {"gender": p_ori}, {"gender": cfg.factor2})
    clip_feats, dino_feats = stack.semantic_feats(hooked)
    loss_clip = loss_lib.cosine_loss(clip_feats, ori["clip_feats"])
    loss_dino = loss_lib.cosine_loss(dino_feats, ori["dino_feats"])
    kept_all = ind & (t == p_ori) & (t != -1) & ori["confident"]["gender"]
    face_valid = ind & (t != -1)
    searched = stack.face_db.semantic_search(res.face_feats.detach())[1] if rows is None else stack.face_db.feats[rows]
    target_embeds = torch.where(kept_all[:, None], ori["face_feats"], searched)
    loss_face = torch.where(face_valid, loss_lib.cosine_loss(res.face_feats, target_embeds.detach()), 0.0)
    dyn_w = weights_lib.dynamic_weights_multi(ind, {"gender": t}, {"gender": p_ori}, {"gender": cfg.factor1},
                                              no_face_weight=1.0)
    out = loss_lib.composite_loss(
        loss_fair=loss_fair, loss_clip=loss_clip, loss_dino=loss_dino, loss_face=loss_face, dynamic_w=dyn_w,
        weight_img=cfg.weight_loss_img, weight_face=cfg.weight_loss_face, fair_valid=fair_valid,
        face_valid=face_valid)
    return out.total, out.logs["loss"].detach(), res.face_feats.detach()


def _slice(tree: Any, sl: slice) -> Any:
    return tree_map(lambda x: x[sl], tree)


def decisions(probs1: np.ndarray, probs3: np.ndarray, cfg: StepConfig) -> dict:
    """The discrete decisions of [N, 2] probabilities: phase 2's gated
    targets of the phase-1 ones, the phase-3 predictions, and whether each
    phase-3 prediction is confident (its probability at least
    `face_confidence_level`)."""
    targets = targets_lib.gate_targets_by_uncertainty(
        targets_lib.binary_rank_targets(probs1, cfg.target_ratio), cfg.uncertainty_threshold)
    confident = torch.as_tensor(probs3.max(-1), dtype=torch.float32) >= cfg.face_confidence_level
    return {"targets": targets, "preds": probs3.argmax(-1).astype(np.int32), "confident": confident.numpy()}


def train_step(sd: RefSD, stack: GuidanceStack, cfg: StepConfig, adapters: dict, opt: torch.optim.Optimizer,
               ema: dict, step: int, cond_ids, uncond_ids, noises: torch.Tensor, n_steps: int,
               follow: Optional[dict] = None) -> dict:
    """One step on `adapters` (fp32 leaves that require grad, updated in
    place with `opt` and `ema`). -> {"loss", "lanes", "grads", "targets",
    "own_targets", "probs1", "probs3", "search", "feats"}: the step's loss,
    each lane's loss, the gradients, the targets it trained toward and those
    of its own probabilities, its phase-1 and phase-3 probabilities [N, 2],
    its own top-1 search rows and face features [N, D] of phase 4. `follow`
    ({"targets", "preds", "confident"} of `decisions`, and "search", the
    rows; either part may be None) gives those decisions instead."""
    n, m, gs = cfg.lanes, cfg.micro_batch, cfg.guidance_scale
    te_lora, unet_lora = adapters.get("te_lora"), adapters.get("unet_lora")
    with torch.no_grad():
        images1, x_final, traj = sd.generate(noises, cond_ids, uncond_ids, n_steps, gs, te_lora=te_lora,
                                             unet_lora=unet_lora, return_latents=True)
        res1 = stack.analyze(images1, include_semantic=False, include_face_feats=False)
        del images1
        images3 = sd.generate(noises, cond_ids, uncond_ids, n_steps, gs)
        res3 = stack.analyze(images3)
        del images3
    probs1 = res1.attrs["gender"].probs.cpu().numpy()
    probs3 = res3.attrs["gender"].probs.cpu().numpy()
    own = decisions(probs1, probs3, cfg)
    d = follow if follow and follow["targets"] is not None else own
    dev = sd.device
    targets = {"gender": torch.as_tensor(d["targets"], device=dev)}
    ori = {
        "face_bboxes": res3.faces.bboxes, "clip_feats": res3.clip_feats, "dino_feats": res3.dino_feats,
        "face_feats": res3.face_feats, "preds": {"gender": torch.as_tensor(d["preds"], device=dev)},
        "confident": {"gender": torch.as_tensor(d["confident"], device=dev)},
    }
    rows = torch.as_tensor(follow["search"], device=dev) if follow and follow["search"] is not None else None

    # phase 4a: dL/dx_final, a lane chunk at a time (the chunk means summed)
    grads_final, per_lane, feats = [], [], []
    for j in range(n // m):
        sl = slice(j * m, (j + 1) * m)
        x = x_final[sl].detach().requires_grad_()
        with torch.enable_grad():
            images = sd.decode(x, grad_mode=True)
            loss, lanes, f = images_loss(stack, cfg, images, _slice(targets, sl), _slice(ori, sl),
                                            None if rows is None else rows[sl])
            (g,) = torch.autograd.grad(loss, x)
        grads_final.append(g)
        per_lane.append(lanes)
        feats.append(f)
    g_final = torch.cat(grads_final)

    # phase 4b: the pair VJPs
    bundle = dpm.make_step_bundle(sd.config.solver, sd.schedule, n_steps)
    gamma = dpm.chain_eps_cotangents(bundle).to(sd.device)
    cot = gamma[:, None, None, None, None] * (g_final / (n // m))[None]
    weights = {}
    if unet_lora is not None:
        with torch.no_grad():
            weights = {k: w.requires_grad_() for k, w in lora_lib.apply_lora(sd.unet, unet_lora).items()}
    w_leaves = list(weights.values())
    with torch.enable_grad():
        # the context of one lane, broadcast to the chunk's in the graph, so
        # its cotangent sums over the lanes
        context, key_mask = sd.build_context(cond_ids, uncond_ids, 1, te_lora)
        ctx_leaf = context.detach().requires_grad_()
        acc_c = torch.zeros(context.shape, dtype=torch.float32, device=sd.device)
        acc_w = [torch.zeros_like(w, dtype=torch.float32) for w in w_leaves]
        ctx_m = ctx_leaf.repeat_interleave(m, dim=0)
        mask_m = key_mask.repeat_interleave(m, dim=0)
        for t_idx in range(traj.shape[0]):
            for j in range(n // m):
                sl = slice(j * m, (j + 1) * m)
                x = traj[t_idx, sl]
                eps2 = sd.unet_eps(torch.cat([x, x]), int(bundle.t[t_idx]), ctx_m, mask_m, weights).float()
                eps_u, eps_c = eps2.chunk(2)
                surrogate = ((eps_u + gs * (eps_c - eps_u)) * cot[t_idx, sl]).sum()
                g = torch.autograd.grad(surrogate, [ctx_leaf, *w_leaves])
                acc_c += g[0]
                for a, gi in zip(acc_w, g[1:]):
                    a += gi
        grads: dict[str, Any] = {}
        if unet_lora is not None:
            deltas = lora_lib.lora_deltas(sd.unet, unet_lora)
            g_unet = torch.autograd.grad(list(deltas.values()), tree_leaves(unet_lora), grad_outputs=acc_w)
            grads["unet_lora"] = tree_unflatten(unet_lora, list(g_unet))
        if te_lora is not None:
            g_te = torch.autograd.grad(context, tree_leaves(te_lora), grad_outputs=acc_c.to(context.dtype))
            grads["te_lora"] = tree_unflatten(te_lora, list(g_te))

    # update: finite gate -> AdamW -> EMA
    params, grad_leaves = tree_leaves(adapters), tree_leaves(grads)
    if all(bool(torch.isfinite(g).all()) for g in grad_leaves):
        for p_, g_ in zip(params, grad_leaves):
            p_.grad = g_.detach()
        opt.step()
    opt.zero_grad(set_to_none=True)
    update_ema(ema, adapters, min(cfg.ema_decay, (1.0 + step) / (10.0 + step)))
    search = stack.face_db.semantic_search(torch.cat(feats))[0].cpu().numpy()
    lanes = torch.cat(per_lane)
    return {"loss": float(lanes.mean()), "lanes": lanes.cpu().numpy(), "grads": grads, "targets": d["targets"],
            "own_targets": own["targets"], "probs1": probs1, "probs3": probs3, "search": search,
            "feats": torch.cat(feats)}
