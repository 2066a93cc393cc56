"""Rank functions for the port's multi-process tests
(test_torch_parallel.py, test_torch_tp.py, test_torch_tools.py).

`fairdiff_torch.parallel.launch.spawn` runs each in fresh processes joined
in one gloo group, so this module imports neither JAX nor the JAX package:
each child starts in seconds. Arguments and results are numpy arrays,
tensors and plain Python values.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _mesh(data: int, model: int):
    from fairdiff_torch.parallel.mesh import MeshConfig, create_mesh

    return create_mesh(MeshConfig(data=data, model=model), device="cpu")


def mesh_ops() -> dict:
    """The mesh helpers on a 2 x 2 mesh: coordinates, this rank's rows,
    sums over each axis, gathered rows (bool and int too), a broadcast from
    data-rank 0 and the backend and tiling checks."""
    from fairdiff_torch.parallel import mesh as M

    mesh = _mesh(2, 2)
    rank = dist.get_rank()
    out = {"rank": rank, "data": M.axis_index(mesh, "data"), "model": M.axis_index(mesh, "model")}
    batch = (torch.arange(10).reshape(5, 2), np.arange(5))
    out["shard"] = M.shard_batch(mesh, batch)
    x = torch.tensor([float(rank), 1.0], dtype=torch.bfloat16)
    out["sum_data"], out["sum_model"] = M.all_sum(x, mesh, "data"), M.all_sum(x, mesh, "model")
    tree = {"a": torch.full((2,), float(rank)), "b": {"c": torch.ones(3) * rank}}
    out["sum_tree"] = M.all_sum_tree(tree, mesh, "data")
    rows = M.data_slice(mesh, 5)
    out["gather_f"] = M.gather_rows(torch.arange(5.0)[rows] * 2, mesh, 5)
    out["gather_b"] = M.gather_rows(torch.arange(5)[rows] % 2 == 0, mesh, 5)
    out["gather_i"] = M.gather_rows(torch.arange(5)[rows] + 10, mesh, 5)
    out["replicated"] = M.replicated(mesh, {"w": torch.full((3,), float(rank))})["w"]
    try:
        M.create_mesh(M.MeshConfig(data=2, model=2), device="cuda")
    except ValueError as e:
        out["backend_error"] = str(e)
    try:
        M.create_mesh(M.MeshConfig(data=3, model=2), device="cpu")
    except ValueError as e:
        out["tiling_error"] = str(e)
    return out


def gather_grad() -> list:
    """`gather_rows_grad`: a loss every rank computes alike on the gathered
    rows, divided by the data size -> each rank's rows' gradient."""
    from fairdiff_torch.parallel import mesh as M

    mesh = _mesh(2, 1)
    x = (torch.arange(4.0)[M.data_slice(mesh, 4)] + 1).requires_grad_()
    full = M.gather_rows_grad(x, mesh, 4)
    ((full ** 3).sum() / 2).backward()
    return [full.detach(), x.grad]


def debias_step(*, data: int, model: int, cfg: dict, params, db_feats, adapters, noises, n_steps: int,
                ids, steps: int = 1, lane_spans=None) -> dict:
    """`steps` port train_steps of the tiny SD (`load_jax(params)`) on a
    data x model mesh (no mesh at 1 x 1) with the synthetic stack; -> the
    last step's global grads, this rank's own before the all-reduce, the
    targets, its logs, adapters, EMA and the trainer's OT draws; with
    `lane_spans`, also each span's share of the step's gradient
    (`chip_smoke.lane_shares`)."""
    import contextlib

    from fairdiff_torch.io.from_jax import adapters_from_jax
    from fairdiff_torch.sampling import pipeline as tpipe
    from fairdiff_torch.training import debias as tdebias
    from fairdiff_torch.training import synthetic as tsyn
    from fairdiff_torch.utils.tree import tree_leaves

    sd = tpipe.StableDiffusion(tpipe.SDConfig.tiny(), device="cpu").load_jax(params)
    stack = tsyn.synthetic_stack(cfg.get("attributes", ("gender",)), db_feats=db_feats, device="cpu")
    mesh = _mesh(data, model) if data * model > 1 else None
    trainer = tdebias.DebiasTrainer(sd, stack, tdebias.DebiasConfig(**cfg), mesh=mesh)
    state = trainer.init_state(adapters=adapters_from_jax(adapters))
    local, reduce = {}, trainer._reduce_grads

    def keep_local(grads):  # this rank's gradients before the all-reduce
        local["grads"] = [g.detach().clone() for g in tree_leaves(grads)]
        return reduce(grads)

    trainer._reduce_grads = keep_local
    if lane_spans:
        from chip_smoke import lane_shares

        sharing = lane_shares(trainer, lane_spans)
    else:
        sharing = contextlib.nullcontext({})
    with sharing as shares:
        for _ in range(steps):
            state, logs = trainer.train_step(state, ids, noises=noises, n_steps=n_steps)
    return {
        "shares": [shares[(i, None)] for i in range(len(lane_spans or []))],
        "grads": tree_leaves(trainer._last_grads), "local": local["grads"], "targets": trainer._last_targets,
        "logs": logs,
        "adapters": tree_leaves(state.adapters), "ema": tree_leaves(state.ema), "ot_draws": trainer.ot_draws,
        "sharded": any(type(m).__name__ == "ColumnParallelLinear" for m in sd.unet.modules()),
    }


def facerec_step(*, data: int, kind: str, fields: dict, params, batches) -> dict:
    """Port FaceRecTrainer steps from the JAX init on a data mesh; -> the
    flat parameters and the losses."""
    from fairdiff_torch.facerec.trainer import FaceRecConfig, FaceRecTrainer
    from fairdiff_torch.models.iresnet import IResNet, IResNetConfig
    from fairdiff_torch.models.sfnet import SFNet, SFNetConfig

    net = SFNet(SFNetConfig.tiny()) if kind == "sfnet" else IResNet(IResNetConfig.tiny())
    trainer = FaceRecTrainer(net, FaceRecConfig(**fields), device="cpu", mesh=_mesh(data, 1) if data > 1 else None)
    state = trainer.init_state(params=params)
    losses = []
    for images, labels in batches:
        state, loss = trainer.train_step(state, images, labels)
        losses.append(loss)
    flat = {f"backbone.{k}": v.detach() for k, v in state["params"]["backbone"].items()}
    flat.update({k: v.detach() for k, v in state["params"].items() if k != "backbone"})
    return {"params": flat, "losses": losses}


def _patch_flash_on_cpu() -> None:
    """Route the UNet's flash sites to `flash_attention` on the CPU too (its
    wrapper runs the plain version for CPU tensors), with the JAX test's
    threshold of one key."""
    from fairdiff_torch.models import layers
    from fairdiff_torch.ops.flash_attention import flash_attention

    plain = layers.dot_product_attention

    def routed(q, k, v, bias=None, flash_bwd="split", use_flash=False, key_mask=None):
        if use_flash and bias is None and key_mask is None:
            return flash_attention(q, k, v, flash_bwd)
        return plain(q, k, v, bias, flash_bwd, use_flash, key_mask)

    layers.dot_product_attention = routed
    import fairdiff_torch.models.unet2d as unet2d

    unet2d.dot_product_attention = routed


def sd_forwards(*, data: int, model: int, params, x, t, ctx, ids, flash: bool = False) -> dict:
    """The tiny UNet's and CLIP text encoder's forwards split over a data x
    model mesh: this rank's rows of each output."""
    from fairdiff_torch.parallel.mesh import shard_batch
    from fairdiff_torch.parallel.tp import shard_sd_modules
    from fairdiff_torch.sampling import pipeline as tpipe

    if flash:
        _patch_flash_on_cpu()
    sd = tpipe.StableDiffusion(tpipe.SDConfig.tiny(), device="cpu").load_jax(params)
    mesh = _mesh(data, model)
    shard_sd_modules(sd, mesh)
    x, t, ctx, ids = shard_batch(mesh, (torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(ctx),
                                        torch.as_tensor(ids)))
    with torch.no_grad():
        eps = sd.unet(x, t, ctx)
        hidden = sd.text_encoder(ids.long())["last_hidden_state"]
    return {"eps": eps, "hidden": hidden, "heads": sd.unet.down_0_attn_0.transformer_blocks_0.attn1.heads}


def facerec_cli(*, config: str, out: str, init_params, data_mesh: int) -> int:
    """`train_facerec.main` with this rank's own output directory."""
    from fairdiff_torch.tools import train_facerec

    cli = train_facerec.FaceRecCLIConfig(device="cpu", config=config, output_dir=f"{out}/rank{dist.get_rank()}",
                                         save_every=2, log_every=1, data_mesh=data_mesh)
    return train_facerec.main(cli, init_params=init_params)["step"]


def debias_cli(*, argv: list[str]) -> list:
    """`train_debias.main` on `argv`; -> the adapters' leaves."""
    from fairdiff_torch.tools import train_debias
    from fairdiff_torch.utils.tree import tree_leaves

    return tree_leaves(train_debias.main(train_debias.parse_args(argv)).adapters)
