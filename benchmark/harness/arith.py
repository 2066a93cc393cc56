"""The benchmark's yardstick arithmetic: the H100's peaks, the operations
and bytes of the flash-attention and GEGLU operations, and the model FLOPs
of a training step and of a generation batch.

Peaks (NVIDIA H100 SXM data sheet, 700 W): 989 TFLOP/s dense bf16, 3.35 TB/s
HBM3, and 3.9 T exponentials a second on the special-function units (16 per
SM per clock, 132 SMs, 1.83 GHz).

`flash_flops`, `flash_bytes` and `bound` are copies of
fairdiff_torch/tools/roofline.py's, counted at the true head dim (never the
kernels' padded one). An operation's work is counted whichever kernel
computes it: attention forward 2 products (QK^T, PV), and 5 for its
backward (S recomputed, dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q),
each input read once and each output written once; one exponential an
(S, T) pair forward and one backward. GEGLU forward is one product
[M, d] x [d, 2I]; its input gradient two (the projection recomputed, then
[dh | dg] x W), as fairdiff_torch's PERF.md states K4's and K5's bounds.

Model FLOPs come from `torch.utils.flop_counter.FlopCounterMode` over the
reference's plain modules run on the `meta` device at the configuration's
shapes: every convolution, linear and attention product, the backward of
frozen weights as the input gradient alone. No recompute is counted (the
reference has no remat).

Relation to fairdiff_torch/tools/roofline.py: its `layer_inventory` (and
`--mode programs`' hooks) counts only `nn.Conv2d` and `nn.Linear`, leaving
attention out, and `FlopCounterMode` on the port does not see its own
kernels; here the plain reference's products are all counted, attention
and GEGLU included.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch import nn

PEAK_BF16_FLOPS = 989.0e12
PEAK_BYTES = 3.35e12
PEAK_EXP = 3.9e12
FLASH_MIN_KV = 512  # self-attention over at least this many keys is the flash operation

PASSES = {"fwd": 2, "fwd_lse": 2, "bwd": 5}


def flash_flops(B, S, T, H, D, kind: str) -> float:
    return 2.0 * B * H * S * T * D * PASSES[kind]


def flash_bytes(B, S, T, H, D, kind: str, dtype_bytes: int = 2) -> float:
    """Each input read once, each output written once (q, k, v, o, dO, dq,
    dk, dv in the input type; lse and delta [B, H, S] fp32)."""
    q = B * S * H * D * dtype_bytes
    kv = 2.0 * B * T * H * D * dtype_bytes
    stat = 4.0 * B * H * S
    return {
        "fwd": 2 * q + kv,  # read q, k, v; write o
        "fwd_lse": 2 * q + kv + stat,  # and lse
        "bwd": 3 * q + 2 * kv + 2 * stat,  # read q, k, v, dO, lse, delta; write dq, dk, dv
    }[kind]


def bound_s(flops: float, nbytes: float, exps: float = 0.0) -> float:
    """The least time for the work: the largest of tensor-core operations,
    device-memory bytes and exponentials over their peak rates (s)."""
    return max(flops / PEAK_BF16_FLOPS, exps / PEAK_EXP, nbytes / PEAK_BYTES)


def flash_bound_s(B, S, T, H, D, kind: str) -> float:
    return bound_s(flash_flops(B, S, T, H, D, kind), flash_bytes(B, S, T, H, D, kind), float(B * H * S * T))


def geglu_cost(M, d, inner, kind: str, dtype_bytes: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of GEGLU over M rows: "fwd" reads x, W, b and writes y;
    "dx" reads x, W, b, dy and writes dx."""
    gemm = 2.0 * M * d * 2 * inner
    io = (M * d + 2 * inner * d + 2 * inner + M * inner) * dtype_bytes
    if kind == "fwd":
        return gemm, io
    return 2 * gemm, io + M * d * dtype_bytes


def geglu_bound_s(M, d, inner, kind: str) -> float:
    return bound_s(*geglu_cost(M, d, inner, kind))


# -- the UNet's attention and GEGLU operations, from the configuration ---
@functools.lru_cache(maxsize=8)
def unet_ops(unet_config) -> dict[str, list[tuple]]:
    """Per UNet row (one CFG half): {"flash": [(S, T, H, D)] of the
    self-attention operations over >= FLASH_MIN_KV keys, "geglu": [(M, d,
    I)] of the feed-forwards}, read from hooks on the reference UNet run
    on the meta device."""
    from benchmark.reference.unet2d import CrossAttention, FeedForwardGEGLU, UNet2DCondition

    with torch.device("meta"):
        unet = UNet2DCondition(unet_config).requires_grad_(False)
    ops: dict[str, list[tuple]] = {"flash": [], "geglu": []}

    def on_attn(mod, args, kwargs):
        x = args[0]
        context = args[1] if len(args) > 1 else kwargs.get("context")
        if context is None and x.shape[1] >= FLASH_MIN_KV:
            ops["flash"].append((x.shape[1], x.shape[1], mod.heads, x.shape[2] // mod.heads))

    def on_ff(mod, args):
        x = args[0]
        ops["geglu"].append((x.shape[0] * x.shape[1], x.shape[2], mod.out.in_features))

    for m in unet.modules():
        if isinstance(m, CrossAttention):
            m.register_forward_pre_hook(on_attn, with_kwargs=True)
        elif isinstance(m, FeedForwardGEGLU):
            m.register_forward_pre_hook(on_ff)
    s, c = unet_config.sample_size, unet_config.in_channels
    ctx = torch.empty(1, 77, unet_config.cross_attention_dim, device="meta")
    with torch.no_grad():
        unet(torch.empty(1, s, s, c, device="meta"), 1, ctx, torch.ones(1, 77, dtype=torch.int32, device="meta"))
    return ops


def unet_bounds_s(unet_config, rows: int, grad: bool) -> tuple[float, float]:
    """(flash, geglu) bound seconds of `rows` UNet rows, forward only or
    forward and backward (the input gradient)."""
    ops = unet_ops(unet_config)
    fa = sum(flash_bound_s(rows, S, T, H, D, "fwd_lse" if grad else "fwd") for S, T, H, D in ops["flash"])
    ge = sum(geglu_bound_s(rows * M, d, inner, "fwd") for M, d, inner in ops["geglu"])
    if grad:
        fa += sum(flash_bound_s(rows, S, T, H, D, "bwd") for S, T, H, D in ops["flash"])
        ge += sum(geglu_bound_s(rows * M, d, inner, "dx") for M, d, inner in ops["geglu"])
    return fa, ge


# -- model FLOPs ---------------------------------------------------------
def count_flops(fn: Callable[[], torch.Tensor], backward: bool = False) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        out = fn()
        if backward:
            out.float().sum().backward()
    return float(fc.get_total_flops())


def _meta(shape, grad: bool = False) -> torch.Tensor:
    return torch.empty(shape, device="meta", requires_grad=grad)


@functools.lru_cache(maxsize=8)
def unit_flops(sd_config, zoo_sizes: tuple[int, int, int], lora: str) -> dict[str, float]:
    """Model FLOPs of one unit of work, from the reference's modules on the
    meta device: "unet" (one row forward), "unet_vjp" (one row forward and
    backward to the context, and to the merged attention weights when
    `lora` is "unet"), "te" (one 77-token row), "te_vjp" (forward and
    backward into the LoRA'd weights when `lora` is "text_encoder"),
    "decode" and "decode_vjp" (one image), "analyze" (detector and
    classifier, one image), "analyze_full" (and the face net on two
    aligned crops, CLIP, DINOv2), "loss_vjp" (decode, the full analysis,
    forward and input backward, one image)."""
    from benchmark.reference.sd import RefSD
    from benchmark.reference.zoo import zoo_modules

    with torch.device("meta"):
        sd = RefSD(sd_config, "meta")
        zoo = {k: m.eval().requires_grad_(False) for k, m in zoo_modules().items()}
    u, t, v = sd_config.unet, sd_config.text, sd_config.vae
    s = u.sample_size
    chip, aligned, _ = zoo_sizes
    ids = torch.zeros(1, t.max_position_embeddings, dtype=torch.long, device="meta")
    ctx = lambda grad: _meta((1, t.max_position_embeddings, u.cross_attention_dim), grad)
    mask = torch.ones(1, t.max_position_embeddings, dtype=torch.int32, device="meta")
    lat = _meta((1, s, s, u.in_channels))
    img = 8 * s

    if lora == "unet":
        for name, p in sd.unet.named_parameters():
            p.requires_grad_(any(k in name for k in ("to_q", "to_k", "to_v", "to_out")) and name.endswith("weight"))
    unet_vjp = count_flops(lambda: sd.unet(lat, 1, ctx(lora == "text_encoder"), mask), backward=True)
    sd.unet.requires_grad_(False)
    unet = count_flops(lambda: sd.unet(lat, 1, ctx(False), mask))
    te = count_flops(lambda: sd.text_encoder(ids)["last_hidden_state"])
    if lora == "text_encoder":
        for name, p in sd.text_encoder.named_parameters():
            p.requires_grad_(("self_attn" in name or "mlp" in name) and name.endswith("weight"))
        te_vjp = count_flops(lambda: sd.text_encoder(ids)["last_hidden_state"], backward=True)
        sd.text_encoder.requires_grad_(False)
    else:
        te_vjp = te
    latent = lambda grad: _meta((1, s, s, v.latent_channels), grad)
    decode = count_flops(lambda: sd.vae.decode(latent(False)))
    decode_vjp = count_flops(lambda: sd.vae.decode(latent(True)), backward=True)

    def zoo_pass(grad: bool, full: bool) -> float:
        heads = lambda out: sum(o.float().sum() for maps in out.values() for o in maps)
        total = count_flops(lambda: heads(zoo["detector"](_meta((1, img, img, 3), grad))), grad)
        total += count_flops(lambda: zoo["classifier"](_meta((1, chip, chip, 3), grad)), grad)
        if full:
            total += count_flops(lambda: zoo["face"](_meta((2, aligned, aligned, 3), grad)), grad)
            total += count_flops(lambda: zoo["clip"](_meta((1, 224, 224, 3), grad))["image_embeds"], grad)
            total += count_flops(lambda: zoo["dino"](_meta((1, 224, 224, 3), grad)), grad)
        return total

    return {"unet": unet, "unet_vjp": unet_vjp, "te": te, "te_vjp": te_vjp, "decode": decode,
            "decode_vjp": decode_vjp, "analyze": zoo_pass(False, False), "analyze_full": zoo_pass(False, True),
            "loss_vjp": decode_vjp + zoo_pass(True, True)}


def train_step_flops(f: dict[str, float], lanes: int, n_steps: int) -> float:
    """Model FLOPs of one linearized exp-1 step: phases 1 and 3 (two
    prompts encoded, 2 x lanes UNet rows a denoising step, the decode and
    the analysis), phase 4a (decode and loss, forward and input backward,
    a lane) and 4b (one UNet row VJP a row a denoising step, one context
    VJP of the two prompts)."""
    sample = 2 * f["te"] + 2 * lanes * n_steps * f["unet"] + lanes * f["decode"]
    phase1 = sample + lanes * f["analyze"]
    phase3 = sample + lanes * f["analyze_full"]
    phase4 = lanes * f["loss_vjp"] + 2 * lanes * n_steps * f["unet_vjp"] + 2 * f["te_vjp"]
    return phase1 + phase3 + phase4


def gen_batch_flops(f: dict[str, float], batch: int, n_steps: int) -> float:
    """Model FLOPs of one CFG generation batch."""
    return 2 * f["te"] + 2 * batch * n_steps * f["unet"] + batch * f["decode"]
