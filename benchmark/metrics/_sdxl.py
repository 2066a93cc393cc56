"""Shared by the SDXL cells' readers: the work of a "gen_sdxl" run counted
from its configuration's shapes on the reference's SDXL modules
(`reference/sdxl.py`, on the `meta` device), with `harness/arith.py`'s
bounds and peak.

- Model FLOPs (`torch.utils.flop_counter.FlopCounterMode`): "unet" one UNet
  row at the configuration's latent size, "te" one prompt through both text
  encoders, "decode" one image; a batch is `arith.gen_batch_flops` of them.
- The UNet's flash and GEGLU operations: hooks on the reference's attention
  and feed-forward modules, as `arith.unet_ops` reads SD-1.5's.

A reader that finds nothing to read (another kind of run, no trace, no such
span) returns nothing."""

from __future__ import annotations

import functools
import hashlib
import inspect
import json

import torch

from benchmark.harness import arith
from benchmark.harness.spec import ROOT
from benchmark.harness.trace import FLASH_BUCKETS, GEGLU_BUCKETS
from benchmark.metrics import _program

KIND = "gen_sdxl"


def _ref_sd(config: dict):
    from benchmark.drivers.gen_sdxl import ref_config
    from benchmark.reference.sdxl import RefSDXL

    with torch.device("meta"):
        return RefSDXL(ref_config(config), "meta")


def _unet_args(sd, rows: int = 1):
    u, t = sd.config.unet, sd.config.text
    s = u.sample_size
    meta = lambda *shape: torch.zeros(shape, device="meta")
    return (meta(rows, s, s, u.in_channels), 1, meta(rows, t.max_position_embeddings, u.cross_attention_dim),
            meta(rows, sd.config.text_2.projection_dim), meta(rows, 6))


def _count_unit_flops(config: dict) -> dict[str, float]:
    sd = _ref_sd(config)
    ids = torch.zeros(1, sd.config.text.max_position_embeddings, dtype=torch.long, device="meta")
    s = sd.config.unet.sample_size
    with torch.no_grad():
        unet = arith.count_flops(lambda: sd.unet(*_unet_args(sd)))
        te = arith.count_flops(lambda: (sd.text_encoder(ids)["penultimate"], sd.text_encoder_2(ids)["text_embeds"]))
        decode = arith.count_flops(lambda: sd.vae.decode(torch.zeros(1, s, s, 4, device="meta")))
    return {"unet": unet, "te": te, "decode": decode}


def unit_flops(config: dict) -> dict[str, float]:
    """Kept under build/benchmark/ of the checkout, keyed on the
    configuration and on this module, arith.py and reference/sdxl.py."""
    from benchmark.reference import sdxl

    src = inspect.getsource(arith) + inspect.getsource(sdxl) + inspect.getsource(_count_unit_flops)
    key = hashlib.sha256((json.dumps(config, sort_keys=True) + src).encode()).hexdigest()[:16]
    path = ROOT / "build" / "benchmark" / f"unit_flops_sdxl-{key}.json"
    if path.exists():
        return json.loads(path.read_text())
    flops = _count_unit_flops(config)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(flops))
    return flops


@functools.lru_cache(maxsize=4)
def _unet_ops(config_json: str) -> dict[str, list[tuple]]:
    from benchmark.reference.unet2d import CrossAttention, FeedForwardGEGLU

    sd = _ref_sd(json.loads(config_json))
    ops: dict[str, list[tuple]] = {"flash": [], "geglu": []}

    def on_attn(mod, args, kwargs):
        x = args[0]
        context = args[1] if len(args) > 1 else kwargs.get("context")
        if context is None and x.shape[1] >= arith.FLASH_MIN_KV:
            ops["flash"].append((x.shape[1], x.shape[1], mod.heads, x.shape[2] // mod.heads))

    def on_ff(mod, args):
        x = args[0]
        ops["geglu"].append((x.shape[0] * x.shape[1], x.shape[2], mod.out.in_features))

    for m in sd.unet.modules():
        if isinstance(m, CrossAttention):
            m.register_forward_pre_hook(on_attn, with_kwargs=True)
        elif isinstance(m, FeedForwardGEGLU):
            m.register_forward_pre_hook(on_ff)
    with torch.no_grad():
        sd.unet(*_unet_args(sd))
    return ops


def unet_ops(config: dict) -> dict[str, list[tuple]]:
    """Per UNet row: {"flash": [(S, T, H, D)] of the self-attention over >=
    FLASH_MIN_KV keys, "geglu": [(M, d, I)] of the feed-forwards}."""
    return _unet_ops(json.dumps(config, sort_keys=True))


def _ours(run) -> bool:
    return run.kind == KIND and run.trace is not None and bool(run.traced_work)


def roofline(run, which: str):
    """The bound times of the traced window's flash or GEGLU operations
    over the profiler's time of their kernels, in %."""
    if not _ours(run):
        return None
    kernel_s = run.trace.bucket_s(FLASH_BUCKETS if which == "flash" else GEGLU_BUCKETS)
    if kernel_s <= 0:
        return None
    ops = unet_ops(run.config)
    rows = sum(2 * w["images"] * w["n_steps"] for w in run.traced_work)
    if which == "flash":
        bound = sum(arith.flash_bound_s(rows, S, T, H, D, "fwd") for S, T, H, D in ops["flash"])
    else:
        bound = sum(arith.geglu_bound_s(rows * M, d, inner, "fwd") for M, d, inner in ops["geglu"])
    return 100.0 * bound / kernel_s if bound > 0 else None


def mfu(run):
    """The traced window's model FLOPs over its time at the bf16 peak, in %."""
    if not _ours(run):
        return None
    f = unit_flops(run.config)
    flops = sum(arith.gen_batch_flops(f, w["images"], w["n_steps"]) for w in run.traced_work)
    return 100.0 * flops / (run.trace.window_s * arith.PEAK_BF16_FLOPS)


def deep_stack_ms(run):
    """Device-stream ms of the deepest "transformer_stack" spans (key: the
    stack's depth) under the traced window's "unet_call" spans, per call."""
    if not _ours(run):
        return None
    window = _program.traced(run)
    calls = _program.spans_in(*window, ("unet_call",))
    from benchmark.drivers.gen_sdxl import ref_config

    depth = max(ref_config(run.config).unet.transformer_layers_per_block)
    deep = [s for s in _program.spans_in(*window, ("transformer_stack",), ("unet_call",))
            if getattr(s, "key", None) == depth]
    d = _program.device_s(deep)
    return 1e3 * sum(d) / len(calls) if calls and d else None
