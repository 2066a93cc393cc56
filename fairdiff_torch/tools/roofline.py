"""Per-kernel roofline ledger for the exp-1 train step (counterpart of
fairdiff/tools/roofline.py), on the card.

  python -m fairdiff_torch.tools.roofline --mode flash      # K1, K2, K3
  python -m fairdiff_torch.tools.roofline --mode programs   # UNet fwd, ctx VJP
  python -m fairdiff_torch.tools.roofline --mode report     # markdown

--mode flash times the four production attention shapes (CFG batch 16)
through K1 (with lse, as a gradient pass runs it), K2 (dq) and K3 (dk/dv)
one at a time with CUDA events, and bills them two ways: the useful FLOPs
(`flash_flops(...)[0]`, the JAX package's count) and the FLOPs at the
kernel's padded head dim (its `DP` template argument, D rounded up to 16).
Bytes are what the port's kernels must move (lse and delta [B, H, S] fp32).
`bound` and `flash_cost` are also what `chip_smoke.py` states as each flash
kernel's `bound_ms`, so the two never disagree.

--mode programs builds the two dominant UNet programs at the production
working point (SD-1.5, CFG batch 16, bf16, 64x64 latents, 77-token context,
filled weights, remat as in training): the forward of phases 1 and 3 and
the context-cotangent VJP (the linearized phase-4 pair program; the frozen
weights take no gradient, so the convolutions run dx only). Each runs alone
under `torch.profiler`; its device time is bucketed by
`utils.trace_summary`, beside a FLOP inventory from forward hooks on every
`nn.Conv2d` and `nn.Linear` (the counterpart of `layer_inventory`) and the
program's FLOPs from `torch.utils.flop_counter.FlopCounterMode` (standing
in for `cost_analysis()`, which also gave bytes: those are not counted).

--mode report renders the JAX tool's markdown table from the saved JSON
(its column names kept: "% MXU roof" is the tensor-core roof here).

Peak rates: NVIDIA H100 SXM, 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, and
3.9 T exponentials a second on the special-function units (NVIDIA's data
sheet at 700 W; a card set below that runs slower).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import torch
from torch import nn

from fairdiff_torch.utils import config as cfglib

PEAK_TFLOPS = 989.0
PEAK_GBS = 3350.0
PEAK_BF16_FLOPS = PEAK_TFLOPS * 1e12
PEAK_BYTES = PEAK_GBS * 1e9
# exponentials a second on the H100 SXM's special-function units (16 per
# SM per clock, 132 SMs, 1.83 GHz): at head dim 40 they bound flash
# attention harder than the tensor cores
PEAK_EXP = 3.9e12

# (name, B, S, T, H, D): the four production attention shapes at the CFG-16
# dispatch batch, per call, unweighted
ATTN_SHAPES = [
    ("self4096", 16, 4096, 4096, 8, 40),
    ("self1024", 16, 1024, 1024, 8, 80),
    ("self256", 16, 256, 256, 8, 160),
    ("cross4096", 16, 4096, 77, 8, 40),
]

# matrix products a kernel makes: fwd 2 (QK^T, PV); dq 3 (QK^T recompute,
# dO V^T, dS K); dkv 4 (QK^T recompute, dO V^T, P^T dO, dS^T Q); the merged
# backward (K6) the union, 5
PASSES = {"fwd": 2, "fwd_lse": 2, "dq": 3, "dkv": 4, "merged": 5}


def padded_head_dim(d: int) -> int:
    """The kernels' head-dim template argument DP: D rounded up to 16
    (csrc/flash_attention.cu FD_DISPATCH_DP)."""
    return -(-d // 16) * 16


def flash_flops(B, S, T, H, D, kind: str) -> tuple[float, float]:
    """(useful, billed at the padded head dim) FLOPs of one call."""
    passes = PASSES[kind]
    return 2.0 * B * H * S * T * D * passes, 2.0 * B * H * S * T * padded_head_dim(D) * passes


def flash_bytes(B, S, T, H, D, kind: str, dtype_bytes: int = 2) -> float:
    """The bytes a call must move: each input read once, each output written
    once (q, k, v, o, dO, dq, dk, dv in the input type; lse and delta
    [B, H, S] fp32)."""
    q = B * S * H * D * dtype_bytes
    kv = 2.0 * B * T * H * D * dtype_bytes
    stat = 4.0 * B * H * S
    return {
        "fwd": 2 * q + kv,  # read q, k, v; write o
        "fwd_lse": 2 * q + kv + stat,  # and lse
        "dq": 3 * q + kv + 2 * stat,  # read q, k, v, dO, lse, delta; write dq
        "dkv": 2 * q + 2 * kv + 2 * stat,  # write dk, dv
        "merged": 3 * q + 2 * kv + 2 * stat,  # write dq, dk, dv
    }[kind]


def flash_cost(B, S, T, H, D, kind: str, dtype_bytes: int = 2) -> dict[str, float]:
    useful, billed = flash_flops(B, S, T, H, D, kind)
    return {"useful_flops": useful, "billed_flops": billed, "bytes": flash_bytes(B, S, T, H, D, kind, dtype_bytes),
            "exps": float(B * H * S * T)}


def bound(flops: float, nbytes: float, exps: float = 0.0) -> tuple[float, str]:
    """The least time for the work: the largest of tensor-core operations,
    device-memory bytes and exponentials over their peak rates (ms, and which
    bound it; the exponential unit counts as operations)."""
    t_ops = max(flops / PEAK_BF16_FLOPS, exps / PEAK_EXP)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def flash_bound(B, S, T, H, D, kind: str, dtype_bytes: int = 2) -> tuple[float, str]:
    """`bound` of one flash call's useful FLOPs, bytes and exponentials."""
    c = flash_cost(B, S, T, H, D, kind, dtype_bytes)
    return bound(c["useful_flops"], c["bytes"], c["exps"])


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Milliseconds a call: CUDA events around `iters` launches after
    `warmup`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _require_cuda() -> str:
    from fairdiff_torch.bench import device_name

    if not torch.cuda.is_available():
        raise RuntimeError("roofline measures the card: no CUDA device here")
    return device_name("cuda")


def mode_flash(out_path: str, iters: int = 30) -> list[dict]:
    from fairdiff_torch.ops import flash_attention as fa

    card = _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, B, S, T, H, D in ATTN_SHAPES:
        q, do = (torch.randn(B, S, H, D, generator=g, device="cuda", dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(B, T, H, D, generator=g, device="cuda", dtype=torch.bfloat16) for _ in range(2))
        o, lse = fa.flash_attention_lse(q, k, v)
        delta = fa.attention_delta(o, do)
        times = {
            "fwd": time_ms(lambda: fa.flash_attention_lse(q, k, v), iters),
            "dq": time_ms(lambda: fa.flash_attention_dq(q, k, v, do, lse, delta), iters),
            "dkv": time_ms(lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta), iters),
        }
        for kind, ms in times.items():
            c = flash_cost(B, S, T, H, D, "fwd_lse" if kind == "fwd" else kind)
            bound_ms, bound_by = bound(c["useful_flops"], c["bytes"], c["exps"])
            t = ms / 1e3
            rows.append({
                "shape": name, "kernel": kind, "ms": ms, "head_dim_billed": padded_head_dim(D),
                "useful_tflops": c["useful_flops"] / t / 1e12,
                "billed_tflops": c["billed_flops"] / t / 1e12,
                "pct_mxu_roof": 100.0 * c["billed_flops"] / t / 1e12 / PEAK_TFLOPS,
                "gbs": c["bytes"] / t / 1e9,
                "pct_hbm_roof": 100.0 * c["bytes"] / t / 1e9 / PEAK_GBS,
                "bound_ms": bound_ms, "bound_by": bound_by, "card": card,
            })
            r = rows[-1]
            print(f"{name:10s} {kind:4s} {ms:8.4f} ms  useful {r['useful_tflops']:6.1f} TF/s  billed "
                  f"{r['billed_tflops']:6.1f} TF/s ({r['pct_mxu_roof']:5.1f}% tensor roof)  {r['gbs']:6.0f} GB/s "
                  f"({r['pct_hbm_roof']:5.1f}% HBM)  bound {bound_ms:.4f} ms ({bound_by})  [{card}]", flush=True)
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    Path(out_path).write_text(json.dumps(rows, indent=1))
    print(f"-> {out_path}")
    return rows


# ---------------------------------------------------------------------------
# analytic conv / dense inventory from forward hooks
# ---------------------------------------------------------------------------

def layer_inventory(module: nn.Module, run) -> dict:
    """FLOPs of every `nn.Conv2d` and `nn.Linear` call while `run()` runs
    (one forward pass): {"conv_flops", "dense_flops", "conv_calls",
    "dense_calls"}. The GEGLU projection, whose weight the fused kernel
    reads without calling its Linear, counts as the dense call it is in
    the JAX package."""
    from fairdiff_torch.models.unet2d import FeedForwardGEGLU

    conv, dense = [], []

    def hook(mod, args, out):
        x = args[0]
        if isinstance(mod, nn.Conv2d):
            k = mod.kernel_size[0] * mod.kernel_size[1] * mod.in_channels // mod.groups
            conv.append(2.0 * out.numel() * k)
        elif isinstance(mod, FeedForwardGEGLU):
            dense.append(2.0 * x.numel() * mod.proj.out_features)
        else:
            dense.append(2.0 * out.numel() * x.shape[-1])

    kinds = (nn.Conv2d, nn.Linear, FeedForwardGEGLU)
    handles = [m.register_forward_hook(hook) for m in module.modules() if isinstance(m, kinds)]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in handles:
            h.remove()
    return {"conv_flops": float(sum(conv)), "dense_flops": float(sum(dense)), "conv_calls": len(conv),
            "dense_calls": len(dense)}


def _build_unet_programs(device="cuda", batch: int = 16):
    """(fwd, ctx_vjp, inventory) at the production working point."""
    from fairdiff_torch.bench import fill_tree
    from fairdiff_torch.models.unet2d import UNet2DCondition, UNetConfig

    cfg = UNetConfig.sd15()
    with torch.device(device):
        # remat as the trainer runs the UNet at full width: each block
        # recomputes its forward in the backward, so the ctx VJP's conv work
        # is fwd + recompute + dx = 3x one pass
        net = fill_tree(UNet2DCondition(cfg, remat=True)).to(torch.bfloat16).eval().requires_grad_(False)
    x = torch.zeros(batch, cfg.sample_size, cfg.sample_size, cfg.in_channels, device=device, dtype=torch.bfloat16)
    t = torch.full((batch,), 500, device=device)
    ctx = torch.full((batch, 77, cfg.cross_attention_dim), 0.1, device=device, dtype=torch.bfloat16)
    cot = torch.ones_like(x)

    def fwd():
        with torch.no_grad():
            return net(x, t, ctx)

    def ctx_vjp():
        # backward() rather than autograd.grad: FlopCounterMode's module
        # hooks do not run under autograd.grad with leaf inputs
        c = ctx.detach().requires_grad_()
        with torch.enable_grad():
            net(x, t, c).backward(cot)
        return c.grad

    return fwd, ctx_vjp, layer_inventory(net, fwd)


def mode_programs(out_dir: str, iters: int = 8) -> dict:
    """Profile the UNet fwd and ctx-VJP programs each alone; save bucket
    times, the FLOP counter's count and the inventory."""
    from torch.utils.flop_counter import FlopCounterMode

    from fairdiff_torch.utils.profiling import trace_to
    from fairdiff_torch.utils.trace_summary import summarize_trace

    card = _require_cuda()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    fwd, vjp, inv = _build_unet_programs()
    print(f"inventory (one fwd pass): {inv}", flush=True)
    results: dict = {"inventory": inv, "iters": iters, "card": card}
    for name, fn in (("fwd", fwd), ("ctx_vjp", vjp)):
        counter = FlopCounterMode(display=False)
        with counter:
            fn()
        cost = {"flops": float(counter.get_total_flops()), "bytes": -1.0}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        print(f"[{name}] {dt * 1e3:.1f} ms/call, {cost['flops'] / 1e12:.2f} TFLOP (FlopCounterMode) [{card}]",
              flush=True)
        tdir = out / f"trace_{name}"
        with trace_to(tdir):
            for _ in range(iters):
                fn()
        summ = summarize_trace(tdir, top=15)
        per_call = {k: v / iters for k, v in summ["by_bucket"].items()}
        print(f"[{name}] buckets ms/call: " + " ".join(f"{k}={v * 1e3:.1f}" for k, v in per_call.items()),
              flush=True)
        results[name] = {
            "s_per_call": dt, "cost_analysis": cost, "bucket_s_per_call": per_call,
            "device_s_per_call": summ["total_s"] / iters,
            "top_ops": [[n, s / iters, c] for n, s, c in summ["top_ops"]],
        }
    (out / "programs.json").write_text(json.dumps(results, indent=1))
    print(f"-> {out / 'programs.json'}")
    return results


def mode_report(flash_json: str, programs_json: str) -> str:
    """Render the ledger table from saved measurements."""
    rows = json.loads(Path(flash_json).read_text())
    prog = json.loads(Path(programs_json).read_text())
    lines = [
        "| kernel | ms/call | useful TF/s | billed TF/s | % MXU roof | GB/s | % HBM roof |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| flash {r['kernel']} {r['shape']} | {r['ms']:.2f} | "
            f"{r['useful_tflops']:.1f} | {r['billed_tflops']:.1f} | "
            f"{r['pct_mxu_roof']:.0f}% | {r['gbs']:.0f} | "
            f"{r['pct_hbm_roof']:.0f}% |"
        )
    inv = prog["inventory"]
    for name in ("fwd", "ctx_vjp"):
        p = prog[name]
        dt = p["s_per_call"]
        conv_t = p["bucket_s_per_call"].get("conv", 0.0)
        # conv FLOPs: fwd = inventory; ctx_vjp = fwd + block remat
        # recompute + dx (no gradient of the frozen weights) = 3x one pass
        factor = 1.0 if name == "fwd" else 3.0
        conv_tf = inv["conv_flops"] * factor / max(conv_t, 1e-9) / 1e12
        ca = p.get("cost_analysis", {})
        mfu = (
            100.0 * ca["flops"] / dt / 1e12 / PEAK_TFLOPS
            if ca.get("flops", -1) > 0 else float("nan")
        )
        bw = (
            ca["bytes"] / dt / 1e9 if ca.get("bytes", -1) > 0
            else float("nan")
        )
        lines.append(
            f"| {name} program (total) | {dt*1e3:.1f} | — | — | "
            f"{mfu:.0f}% MFU | {bw:.0f} | {100*bw/PEAK_GBS:.0f}% |"
        )
        if conv_t > 0:
            lines.append(
                f"| {name} conv bucket | {conv_t*1e3:.1f} | {conv_tf:.1f} | "
                f"{conv_tf:.1f} | {100*conv_tf/PEAK_TFLOPS:.0f}% | — | — |"
            )
        else:
            lines.append(f"| {name} conv bucket | — | — | — | — | — | — |")
    report = "\n".join(lines)
    print(report)
    return report


@dataclasses.dataclass(frozen=True)
class RooflineConfig:
    mode: str = "flash"  # flash | programs | report
    out_dir: str = "outputs/roofline"
    iters: int = 30
    prog_iters: int = 8


def main(cfg: RooflineConfig):
    out = Path(cfg.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if cfg.mode == "flash":
        return mode_flash(str(out / "flash.json"), iters=cfg.iters)
    if cfg.mode == "programs":
        return mode_programs(str(out), iters=cfg.prog_iters)
    if cfg.mode == "report":
        return mode_report(str(out / "flash.json"), str(out / "programs.json"))
    raise SystemExit(f"unknown mode {cfg.mode}")


if __name__ == "__main__":
    main(cfglib.cli_parse(RooflineConfig))
