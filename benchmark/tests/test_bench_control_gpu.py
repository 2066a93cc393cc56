"""The control at the cells' own size, on the card: the reference in fp8
(the precision below the configuration's bf16) in the program's place,
against the fp32 reference, on three seeds a cell; for the training cells
also the fault "half of the batch left out, the mean taken over the rest",
planted in the reference put in the program's place. Each must fail a
limit; the readings print (`-s`) and set the limits' upper readings in
PERF.md.

    python3 -m pytest -m gpu -s benchmark/tests/test_bench_control_gpu.py
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import compare
from benchmark.harness.spec import cell, load_bench

SEEDS = (3_100_000_001, 3_100_000_002, 3_100_000_003)


def _ctx(workload: str, seed: int):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return bench_run.Context(cell(workload, load_bench()), seed, 0.0, False, "cuda", time.perf_counter())


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", ["train-exp1"])
def test_train_control_and_half_batch_fail(workload, seed, monkeypatch):
    from benchmark.drivers import train
    from benchmark.reference import trainer

    ctx = _ctx(workload, seed)
    first = next(train.first_step(ctx))
    ref = train.run_reference(ctx, first)
    torch.cuda.empty_cache()
    low = train.run_reference(ctx, first, fp8=True, follow=ref)
    torch.cuda.empty_cache()
    orig = trainer.images_loss

    def half_batch(stack, cfg, images, targets, ori, rows=None):
        h = slice(0, images.shape[0] // 2)
        total, lanes, feats = orig(stack, cfg, images[h], trainer._slice(targets, h), trainer._slice(ori, h),
                                   None if rows is None else rows[h])
        return total, torch.cat([lanes, lanes]), torch.cat([feats, feats])

    monkeypatch.setattr(trainer, "images_loss", half_batch)
    half = train.run_reference(ctx, first, follow=ref)
    results = {}
    for name, other in (("control", low), ("half_batch", half)):
        ok, checks = compare.judge(train.numbers(other, ref), ctx.cell["limits"])
        results[name] = ok
        print(json.dumps({name: workload, "seed": seed, "checks": checks}), flush=True)
    assert not any(results.values())


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_gen_control_fails(seed):
    from benchmark.drivers import gen

    ctx = _ctx("gen-unet-lora", seed)
    gap = gen.control_gap(ctx)
    ok, checks = compare.judge({"image_rel_l2": gap}, ctx.cell["limits"])
    print(json.dumps({"control": "gen-unet-lora", "seed": seed, "checks": checks}), flush=True)
    assert not ok
