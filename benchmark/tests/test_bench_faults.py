"""A whole run at the tiny size on the CPU (the look for a chip skipped)
with the timed path broken underneath: `correct` comes out false for each
fault a cell can have, and true without one."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests.tiny import tiny_cell

SEED = 2**31 + 99


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CELLS = {"train-exp1": ("train-exp1",), "gen-unet-lora": ("gen-unet-lora",),
         "train-unet-lora": ("train-unet-lora", "sd15-unet-lora", "exp1-step", "train-exp1")}


def _run(workload):
    return bench_run.run_cell(tiny_cell(*CELLS[workload]), SEED, 0.1, False, "cpu", time.perf_counter())


def _state_unchanged(monkeypatch):
    from fairdiff_torch.training.debias import DebiasTrainer

    orig = DebiasTrainer.train_step

    def step(self, state, *args, **kwargs):
        state.opt.step = lambda *a, **k: None  # the update is dropped
        try:
            return orig(self, state, *args, **kwargs)
        finally:
            del state.opt.step

    monkeypatch.setattr(DebiasTrainer, "train_step", step)


def _half_the_batch(monkeypatch):
    from fairdiff_torch.training import debias

    orig = debias.DebiasTrainer._images_loss

    def loss(self, images, targets, ori):
        h = images.shape[0] // 2
        total, logs = orig(self, images[:h], debias._slice_tree(targets, slice(0, h)),
                           debias._slice_tree(ori, slice(0, h)))
        return total, {k: torch.cat([v, v]) for k, v in logs.items()}

    monkeypatch.setattr(debias.DebiasTrainer, "_images_loss", loss)


def _image_altered(monkeypatch):
    from fairdiff_torch.sampling.pipeline import StableDiffusion

    orig = StableDiffusion.generate
    monkeypatch.setattr(StableDiffusion, "generate", lambda self, *a, **k: orig(self, *a, **k).flip(2))


def _jpeg_cut(monkeypatch):
    from fairdiff_torch.io import images

    orig = images.write_image

    def write(img, path, quality=95):
        orig(img, path, quality)
        data = open(path, "rb").read()
        open(path, "wb").write(data[: len(data) // 2])

    monkeypatch.setattr(images, "write_image", write)


@pytest.mark.parametrize("workload,fault", [
    ("train-exp1", _state_unchanged), ("train-exp1", _half_the_batch),
    ("train-unet-lora", _state_unchanged), ("train-unet-lora", _half_the_batch),
    ("gen-unet-lora", _image_altered), ("gen-unet-lora", _jpeg_cut),
])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(workload)
    assert not res["correct"], res["checks"]


def test_the_control_fails_the_limits():
    """The reference in fp8 in the program's place fails a limit at the
    tiny size too (the chip's readings at the cells' size are in PERF.md)."""
    from benchmark.drivers import gen, train
    from benchmark.harness import compare

    for workload in ("train-exp1", "train-unet-lora"):
        ctx = bench_run.Context(tiny_cell(*CELLS[workload]), SEED, 0.1, False, "cpu", time.perf_counter())
        first = next(train.first_step(ctx))
        ref = train.run_reference(ctx, first)
        ok, checks = compare.judge(train.numbers(train.run_reference(ctx, first, fp8=True, follow=ref), ref),
                                   ctx.cell["limits"])
        assert not ok, (workload, checks)
    ctx = bench_run.Context(tiny_cell("gen-unet-lora"), SEED, 0.1, False, "cpu", time.perf_counter())
    ok, checks = compare.judge({"image_rel_l2": gen.control_gap(ctx)}, ctx.cell["limits"])
    assert not ok, checks
