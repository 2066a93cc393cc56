"""Generation-throughput batch sweep (counterpart of
fairdiff/tools/bench_gen.py): images a second of 50-step DPM-Solver++ CFG
generation at SD-1.5 width in bf16 on filled weights (`bench.GenBench`),
at each batch, so a serving batch is a measured choice.

  python -m fairdiff_torch.tools.bench_gen --batches 10,16,20 --timed 2

One set of filled weights serves every batch; each batch runs once
untimed, then `--timed` times. There is no ahead-of-time compile to
overlap. Each row is one JSON line with the card's name and power limit;
without a card it raises.
`est_mfu` counts 0.68 TFLOP a UNet image-forward (x2 CFG x steps) and 1.2
TFLOP a VAE decode, over 989 TFLOP/s (the H100's dense bf16 peak).
"""

from __future__ import annotations

import argparse
import json

from fairdiff_torch.tools.roofline import PEAK_TFLOPS


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="10,16,20")
    ap.add_argument("--timed", type=int, default=2)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--json_out", default="")
    args = ap.parse_args(argv)

    from fairdiff_torch.bench import GenBench, device_name

    rows = []
    sd = None
    for n in (int(b) for b in args.batches.split(",")):
        gb = GenBench(n, steps=args.steps, sd=sd)
        sd = gb.sd
        ips = gb.run(n_timed=args.timed, emit=False)
        tflop_per_img = 0.68 * 2 * args.steps + 1.2
        rows.append({"batch": n, "img_per_s": ips, "s_per_batch": n / ips,
                     "est_mfu": ips * tflop_per_img / PEAK_TFLOPS, "device": device_name(sd.device)})
        print(json.dumps(rows[-1]), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
