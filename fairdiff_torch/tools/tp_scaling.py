"""Memory scaling of the phase-4 pair VJP with its lanes and the model axis
(counterpart of fairdiff/tools/tp_scaling.py).

The memory-critical program of a step is the linearized phase-4 pair VJP:
a single-step UNet VJP over p lanes at CFG batch 2p
(`DebiasTrainer._pair_grads`). Two modes:

  --mode trainer_pair  the trainer's own pair VJP (bench.build: SD-1.5 at
      filled weights without remat, as the JAX bench builds it, so one
      step's whole UNet activations are held; or the tiny stack with
      --tiny 1) at each lane count
      p of --lanes. A p that does not divide train_images_per_prompt is
      skipped and recorded as a "skipped" row. Each measured row holds the
      argument bytes (the frozen text encoder and UNet, the adapters, the
      trajectory and cotangent inputs), the bytes autograd saves in the
      VJP's forward beyond those arguments (`saved_gb`, each storage
      counted once by a `saved_tensors_hooks` pass that skips the
      arguments' storages: the device-independent counterpart of XLA's
      `memory_analysis()` temp bytes, which leave the arguments out too)
      and, on CUDA, the peak
      `torch.cuda.max_memory_allocated` of the pair VJP. A fit over the
      first and last measured rows gives the bytes a lane, the fixed bytes
      and the lanes that fit one card of --hbm_budget_gb (80: the H100's)
      and, lanes being embarrassingly parallel, two cards on the data axis.
  --mode unet_vjp  the one-step UNet VJP with a LoRA merged, at each p, with
      the model axis of each --model_axes value above 1 as that many
      processes (`parallel.launch`, gloo) holding their slice of the
      attention (`parallel.tp`), 1 in this process: each rank's argument and
      saved bytes (and peak, on CUDA).

  python -m fairdiff_torch.tools.tp_scaling --mode trainer_pair --lanes 4,8,12,24
  python -m fairdiff_torch.tools.tp_scaling --mode unet_vjp --device cpu --tiny 1

Every row names the device (the card's name and power limit).
"""

from __future__ import annotations

import dataclasses
import json
import tempfile
import time
from contextlib import contextmanager

import torch

from fairdiff_torch.utils import config as cfglib
from fairdiff_torch.utils.tree import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TPScalingConfig:
    mode: str = "unet_vjp"  # unet_vjp | trainer_pair
    device: str = ""  # "" = cuda; "cpu" only when asked for
    lanes: tuple[int, ...] = (4, 8, 12)
    model_axes: tuple[int, ...] = (1, 2)
    tiny: bool = False  # tiny SD config (smoke/tests)
    lora_rank: int = 50
    hbm_budget_gb: float = 80.0  # the H100's
    json_out: str = ""  # optional results file


def _gb(n: float) -> float:
    return round(n / 2**30, 3)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@contextmanager
def saved_bytes(args=()):
    """Count the bytes autograd saves inside the block, each storage once
    and none of the storages of `args` (the tensors counted as arguments: a
    linear or convolution saves its frozen weight for the input's
    gradient); yields a dict whose "bytes" holds the count on exit."""
    seen = {t.untyped_storage().data_ptr() for t in args}
    out = {"bytes": 0}

    def pack(t: torch.Tensor):
        storage = t.untyped_storage()
        if storage.data_ptr() not in seen:
            seen.add(storage.data_ptr())
            out["bytes"] += storage.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        yield out


def _peak(device: torch.device, run) -> float | None:
    """Peak bytes allocated while `run()` runs (CUDA), else None."""
    if device.type != "cuda":
        run()
        return None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    run()
    torch.cuda.synchronize(device)
    return float(torch.cuda.max_memory_allocated(device))


def _device_label(device: torch.device) -> str:
    from fairdiff_torch.bench import device_name

    return device_name(device)


def trainer_pair_sweep(cfg: TPScalingConfig) -> list[dict]:
    """Bytes autograd saves in the trainer's pair VJP, run eagerly
    (`EagerPairTrainer`; on the card the trainer replays a CUDA graph of the
    same body), at several lane counts."""
    from fairdiff_torch import bench
    from fairdiff_torch.sampling import dpm_solver as dpm
    from fairdiff_torch.training.debias import EagerPairTrainer

    sd, guidance, dcfg = bench.build(cfg.tiny, device=cfg.device or None)
    trainer = EagerPairTrainer(sd, guidance, dcfg)
    state = trainer.init_state(1)
    dev, label = sd.device, _device_label(sd.device)
    v, S = sd.config.text.vocab_size, sd.config.text.max_position_embeddings
    ids = torch.full((1, S), v - 1, dtype=torch.long)
    ids[0, 0] = 0
    bundle = dpm.make_step_bundle(sd.config.solver, sd.schedule, 1)
    frozen = [*sd.unet.parameters(), *sd.text_encoder.parameters()]
    rows = []
    n_lanes = dcfg.train_images_per_prompt
    for p in cfg.lanes:
        if p <= 0 or n_lanes % p:
            rows.append({"mode": "trainer_pair", "lanes": p,
                         "skipped": f"{p} does not divide {n_lanes} total lanes"})
            print(json.dumps(rows[-1]), flush=True)
            continue
        g = torch.Generator().manual_seed(p)
        traj = torch.randn((1, *sd.latent_shape(p)), generator=g).to(dev)
        cot = torch.randn((1, *sd.latent_shape(p)), generator=g).to(dev)
        call = lambda: trainer._pair_grads(state.adapters, traj, cot, bundle.t, ids, ids, p)  # noqa: E731
        arg_tensors = [*frozen, *tree_leaves(state.adapters), traj, cot]
        t0 = time.perf_counter()
        with saved_bytes(arg_tensors) as saved:
            grads = call()
        seconds = time.perf_counter() - t0
        peak = _peak(dev, call)
        if not all(bool(torch.isfinite(x).all()) for x in tree_leaves(grads)):
            raise AssertionError(f"trainer_pair: non-finite gradients at {p} lanes")
        args = _nbytes(arg_tensors)
        rows.append({
            "mode": "trainer_pair", "lanes": p, "arg_gb": _gb(args), "saved_gb": _gb(saved["bytes"]),
            "total_gb": _gb(args + saved["bytes"]), "peak_gb": None if peak is None else _gb(peak),
            "fits_hbm": args + saved["bytes"] <= cfg.hbm_budget_gb * 2**30, "seconds": round(seconds, 3),
            "device": label,
        })
        print(json.dumps(rows[-1]), flush=True)
        del traj, cot, grads, arg_tensors
    measured = [r for r in rows if "saved_gb" in r]
    if len(measured) < 2:
        print(json.dumps({"mode": "trainer_pair_fit", "skipped": f"need >=2 measured lane counts for the slope "
                          f"fit, got {len(measured)} (skipped rows excluded)"}), flush=True)
    else:
        # per-lane slope from the first and last points (the arguments are
        # lane-independent frozen weights; the saved bytes scale with lanes)
        a, b = measured[0], measured[-1]
        slope = (b["saved_gb"] - a["saved_gb"]) / (b["lanes"] - a["lanes"])
        fixed = a["saved_gb"] - slope * a["lanes"] + a["arg_gb"]
        one = int((cfg.hbm_budget_gb - fixed) // max(slope, 1e-9))
        print(json.dumps({
            "mode": "trainer_pair_fit", "gb_per_lane": round(slope, 3), "fixed_gb": round(fixed, 3),
            "max_lanes_1chip": one,
            # lanes are embarrassingly parallel over the data axis; a model
            # axis projection is not made (the binding activations are
            # batch-dim'd and replicate under "model")
            "max_lanes_2chip_dp": 2 * one, "hbm_budget_gb": cfg.hbm_budget_gb, "device": label,
        }), flush=True)
    return rows


def unet_vjp_rank(*, tiny: bool, lanes: tuple[int, ...], lora_rank: int, model: int, device: str) -> list[dict]:
    """One rank of the unet_vjp sweep: the UNet (its attention split over a
    `model`-way axis), a LoRA merged, and the VJP of <cot, eps> into the
    LoRA, the latents and the context at each lane count."""
    import torch.distributed as dist

    from fairdiff_torch import bench
    from fairdiff_torch.adapters import lora as lora_lib
    from fairdiff_torch.parallel.mesh import MeshConfig, create_mesh
    from fairdiff_torch.parallel.tp import shard_sd_modules
    from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion

    sd = StableDiffusion(SDConfig.tiny() if tiny else SDConfig.sd15(), device=device or None)
    if tiny:
        sd.init_random(0)
    else:
        for m in sd.models().values():
            bench.fill_tree(m)
    lora = lora_lib.init_lora(sd.unet, lora_lib.unet_attention_targets, lora_rank, torch.Generator().manual_seed(1))
    if model > 1:
        shard_sd_modules(sd, create_mesh(MeshConfig(data=1, model=model), device=sd.device,
                                         backend=dist.get_backend()))
    leaves = [t.to(sd.device).requires_grad_() for t in tree_leaves(lora)]
    lora = tree_unflatten(lora, leaves)
    s, ctx_len, ctx_dim = sd.config.unet.sample_size, 16 if tiny else 77, sd.config.unet.cross_attention_dim
    rows = []
    for p in lanes:
        b = 2 * p  # CFG doubling
        g = torch.Generator().manual_seed(p)
        lat2 = torch.randn(b, s, s, 4, generator=g).to(sd.device).requires_grad_()
        ctx = torch.randn(b, ctx_len, ctx_dim, generator=g).to(sd.device, sd.dtype).requires_grad_()

        def vjp():
            weights = lora_lib.apply_lora(sd.unet, lora)
            eps = sd.unet_eps(lat2, 501, ctx, unet_weights=weights)
            return torch.autograd.grad(eps, [*leaves, lat2, ctx], torch.ones_like(eps))

        arg_tensors = [*sd.unet.parameters(), *leaves, lat2, ctx]
        with saved_bytes(arg_tensors) as saved:
            vjp()
        peak = _peak(sd.device, vjp)
        args = _nbytes(arg_tensors)
        rank = dist.get_rank() if model > 1 else 0
        rows.append({"mode": "unet_vjp", "mesh": f"data=1 model={model}", "rank": rank, "lanes": p,
                     "arg_gb": _gb(args), "saved_gb": _gb(saved["bytes"]),
                     "peak_gb": None if peak is None else _gb(peak)})
    return rows


def unet_vjp_sweep(cfg: TPScalingConfig) -> list[dict]:
    """Per-rank bytes of the one-step UNet VJP for each model axis."""
    from fairdiff_torch.device import resolve_device
    from fairdiff_torch.parallel.launch import spawn

    device = resolve_device(cfg.device or None)
    label = _device_label(device)
    rows = []
    with tempfile.TemporaryDirectory() as work:
        for m in cfg.model_axes:
            kwargs = dict(tiny=cfg.tiny, lanes=tuple(cfg.lanes), lora_rank=cfg.lora_rank, model=m, device=device.type)
            if m == 1:  # one rank: this process
                out = [unet_vjp_rank(**kwargs)]
            else:
                out = spawn("fairdiff_torch.tools.tp_scaling:unet_vjp_rank", m, backend="gloo", workdir=work,
                            timeout=1800, device=device.type, threads=1 if device.type == "cpu" else 4,
                            kwargs=kwargs)
            for rank_rows in out:
                for r in rank_rows:
                    rows.append(dict(r, device=label))
                    print(json.dumps(rows[-1]), flush=True)
    return rows


def main(cfg: TPScalingConfig) -> list[dict]:
    rows = unet_vjp_sweep(cfg) if cfg.mode == "unet_vjp" else trainer_pair_sweep(cfg)
    if cfg.json_out:
        with open(cfg.json_out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main(cfglib.cli_parse(TPScalingConfig))
