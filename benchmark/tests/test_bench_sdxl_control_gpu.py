"""The SDXL cell's control at its own size, on the card: the reference in fp8
(the precision below the configuration's bf16) in the program's place,
against the fp32 reference, on three seeds. Each must fail the cell's limit;
the readings print (`-s`) and set the limit's upper reading in PERF.md.

    python3 -m pytest -m gpu -s benchmark/tests/test_bench_sdxl_control_gpu.py
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import compare
from benchmark.harness.spec import cell, load_bench

SEEDS = (3_100_000_101, 3_100_000_102, 3_100_000_103)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_gen_sdxl_control_fails(seed):
    from benchmark.drivers import gen_sdxl

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ctx = bench_run.Context(cell("gen-sdxl-unet-lora", load_bench()), seed, 0.0, False, "cuda", time.perf_counter())
    gap = gen_sdxl.control_gap(ctx)
    ok, checks = compare.judge({"image_rel_l2": gap}, ctx.cell["limits"])
    print(json.dumps({"control": "gen-sdxl-unet-lora", "seed": seed, "checks": checks}), flush=True)
    assert not ok
