"""Microbenchmark: flash attention (K1; with `--grad` the whole forward and
backward) against its plain version and SDPA on the card (counterpart of
fairdiff/tools/bench_attention.py).

SD-1.5 UNet attention shapes (batch 8 = 4 images x CFG):
  64x64 latents: S=T=4096, H=8, D=40   (top blocks, the hot one)
  32x32 latents: S=T=1024, H=8, D=80
  16x16 latents: S=T= 256, H=8, D=160
  cross-attn:    S=4096,  T=77, H=8, D=40

  python -m fairdiff_torch.tools.bench_attention [--dtype bf16|f32] [--grad]
      [--only self64] [--modes split,merged,recompute]

The forward times K1 (`flash_attention`, no gradient), the plain version
(`flash_attention_plain`) and `F.scaled_dot_product_attention` (a
comparator; the port never calls it) on the same inputs, and states K1's
largest difference from the plain version. `--grad` times a whole forward
and backward (`flash_attention(..., flash_bwd)` then autograd) for each
backward route, "split" (K1 with lse, K2, K3), "merged" (K6) and
"recompute" (the plain attention's autograd), and states each route's
largest gradient difference from the first route's. Times are CUDA events
over a loop of launches after a warm-up; every line names the card and its
power limit.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

SHAPES = [
    ("self64", 8, 4096, 4096, 8, 40),
    ("self32", 8, 1024, 1024, 8, 80),
    ("self16", 8, 256, 256, 8, 160),
    ("cross64", 8, 4096, 77, 8, 40),
]
ITERS = 20  # launches a timed loop


def _inputs(b, s, t, h, d, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, s, h, d, generator=g, device="cuda", dtype=dtype)
    k, v = (torch.randn(b, t, h, d, generator=g, device="cuda", dtype=dtype) for _ in range(2))
    return q, k, v


def forward_rows(dtype, only: str | None, card: str) -> list[dict]:
    from fairdiff_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from fairdiff_torch.tools.roofline import time_ms

    rows = []
    for name, b, s, t, h, d in SHAPES:
        if only and name != only:
            continue
        q, k, v = _inputs(b, s, t, h, d, dtype)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        err = (flash_attention(q, k, v).float() - flash_attention_plain(q, k, v).float()).abs().max().item()
        r = {"shape": name, "kernel_ms": time_ms(lambda: flash_attention(q, k, v), ITERS),
             "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v), ITERS // 5),
             "sdpa_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), ITERS),
             "max_abs_err": err, "card": card}
        rows.append(r)
        print(f"{name:8s} plain {r['plain_ms']:8.3f} ms   flash {r['kernel_ms']:8.3f} ms   "
              f"speedup {r['plain_ms'] / r['kernel_ms']:5.2f}x   sdpa {r['sdpa_ms']:8.3f} ms   "
              f"max|err| {err:.4f}   [{card}]", flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def grad_rows(dtype, only: str | None, modes: tuple[str, ...], card: str) -> list[dict]:
    from fairdiff_torch.ops.flash_attention import flash_attention
    from fairdiff_torch.tools.roofline import time_ms

    rows = []
    for name, b, s, t, h, d in SHAPES:
        if only and name != only:
            continue
        q, k, v = (x.requires_grad_() for x in _inputs(b, s, t, h, d, dtype))

        def step(mode):
            o = flash_attention(q, k, v, mode)
            return torch.autograd.grad((o.float() ** 2).sum(), (q, k, v))

        times, grads = {}, {}
        for mode in modes:
            grads[mode] = [g.float() for g in step(mode)]
            times[mode] = time_ms(lambda: step(mode), ITERS)
        first = modes[0]
        diff = {m: max((a - b_).abs().max().item() for a, b_ in zip(grads[m], grads[first])) for m in modes}
        rows.append({"shape": name, "ms": times, "max_abs_grad_diff_vs_" + first: diff, "card": card})
        print(f"{name:8s} " + "   ".join(f"{m} {times[m]:8.3f} ms" for m in modes)
              + "   max|dgrad| vs " + first + " " + " ".join(f"{m} {diff[m]:.4f}" for m in modes[1:])
              + f"   [{card}]", flush=True)
        del q, k, v, grads
        torch.cuda.empty_cache()
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"))
    ap.add_argument("--grad", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--modes", default="split,merged,recompute")
    args = ap.parse_args(argv)

    from fairdiff_torch.bench import device_name

    if not torch.cuda.is_available():
        raise RuntimeError("bench_attention measures the card: no CUDA device here")
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    card = device_name("cuda")
    print(f"device={torch.cuda.get_device_name(0)} dtype={args.dtype}{' (fwd+bwd)' if args.grad else ''}")
    if args.grad:
        return grad_rows(dtype, args.only or None, tuple(args.modes.split(",")), card)
    return forward_rows(dtype, args.only or None, card)


if __name__ == "__main__":
    main()
