"""Microbenchmark: the fused GEGLU kernels against the plain composition on
the card (counterpart of fairdiff/tools/bench_geglu.py).

SD-1.5 UNet feed-forward shapes (rows = CFG-pair batch 16 x tokens):
  64x64 latents: T=4096, d= 320  (the hot one)
  32x32 latents: T=1024, d= 640
  16x16 latents: T= 256, d=1280
  mid block:     T=  64, d=1280

Times the forward (K4 against `geglu_plain` and `F.linear`, the projection
alone, a comparator the port never calls in its place) and the dx backward
(K5 against `geglu_dx_plain`: the feed-forward weights are frozen, so dx is
the production gradient), with CUDA events over a loop of launches after a
warm-up, and states K4's and K5's largest differences from their plain
versions. Every line names the card and its power limit.

  python -m fairdiff_torch.tools.bench_geglu [--batch 16] [--iters 20]
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

SHAPES = [  # (name, tokens, dim)
    ("ff64", 4096, 320),
    ("ff32", 1024, 640),
    ("ff16", 256, 1280),
    ("ffmid", 64, 1280),
]


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    from fairdiff_torch.bench import device_name
    from fairdiff_torch.ops import geglu as gg
    from fairdiff_torch.tools.roofline import time_ms

    if not torch.cuda.is_available():
        raise RuntimeError("bench_geglu measures the card: no CUDA device here")
    card = device_name("cuda")
    print(f"device={torch.cuda.get_device_name(0)} batch={args.batch} bf16")
    rows = []
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, T, d in SHAPES:
        inner, m = 4 * d, args.batch * T
        x = torch.randn(m, d, generator=g, device="cuda", dtype=torch.bfloat16)
        w = (torch.randn(2 * inner, d, generator=g, device="cuda") * d**-0.5).to(torch.bfloat16)
        b = (torch.randn(2 * inner, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
        dy = torch.randn(m, inner, generator=g, device="cuda", dtype=torch.bfloat16)
        r = {
            "shape": name, "rows": m, "d": d, "card": card,
            "fwd_ms": time_ms(lambda: gg.geglu(x, w, b), args.iters),
            "fwd_plain_ms": time_ms(lambda: gg.geglu_plain(x, w, b), args.iters),
            "linear_ms": time_ms(lambda: F.linear(x, w, b), args.iters),
            "dx_ms": time_ms(lambda: gg.geglu_dx(x, w, b, dy), args.iters),
            "dx_plain_ms": time_ms(lambda: gg.geglu_dx_plain(x, w, b, dy), args.iters),
            "fwd_max_abs_err": (gg.geglu(x, w, b).float() - gg.geglu_plain(x, w, b).float()).abs().max().item(),
            "dx_max_abs_err": (gg.geglu_dx(x, w, b, dy).float()
                               - gg.geglu_dx_plain(x, w, b, dy).float()).abs().max().item(),
        }
        rows.append(r)
        print(f"{name:6s} d={d:4d} [plain] fwd {r['fwd_plain_ms']:8.3f} ms   dx {r['dx_plain_ms']:8.3f} ms   "
              f"[fused] fwd {r['fwd_ms']:8.3f} ms   dx {r['dx_ms']:8.3f} ms   [F.linear] {r['linear_ms']:8.3f} ms"
              f"   max|fused-plain| fwd {r['fwd_max_abs_err']:.5f} dx {r['dx_max_abs_err']:.5f}   [{card}]",
              flush=True)
        del x, w, b, dy
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
