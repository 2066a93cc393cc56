"""The frozen reference agrees with fairdiff_torch at tiny width on the
CPU: a whole run of each cell (set-up, window, reference) at the tiny
size, every compared number at rounding level; the modules' parameters
named and shaped alike on both sides at full width."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests.tiny import tiny_cell

SEED = 2**31 + 4242


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# train-unet-lora: the UNet-LoRA configuration under exp-1's step, a cell for
# a later PR (PERF.md, Open questions), held to train-exp1's limits
CELLS = {"train-exp1": ("train-exp1",), "gen-unet-lora": ("gen-unet-lora",),
         "train-unet-lora": ("train-unet-lora", "sd15-unet-lora", "exp1-step", "train-exp1")}


@pytest.mark.parametrize("workload", list(CELLS))
def test_tiny_run_is_correct_and_at_rounding_level(workload):
    res = bench_run.run_cell(tiny_cell(*CELLS[workload]), SEED, 0.2, False, "cpu", time.perf_counter())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    for name, (value, limit) in res["checks"].items():
        assert value < 1e-4, (name, value)  # fp32 on both sides, other summation orders
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in tiny_cell(*CELLS[workload])["end_to_end"]}


def test_a_cell_added_by_files_and_entries_alone_runs(tmp_path):
    """PERF.md's worked example: `gen-te-lora`, generation with the
    text-encoder LoRA, is one new limits file and one new workload entry;
    no file of the benchmark is edited."""
    import json
    import shutil

    from benchmark.harness import spec
    from benchmark.tests.tiny import shrink

    shutil.copytree(spec.ROOT / "benchmark", tmp_path / "benchmark")
    bench = spec.load_bench()
    bench["workloads"].append({"name": "gen-te-lora", "config": "sd15-te-lora", "traffic": "protocol-gen", "chips": 1,
                               "why": "generation with the text-encoder LoRA"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "gen-unet-lora" in m.get("workloads", []):
            m["workloads"].append("gen-te-lora")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "benchmark" / "limits" / "gen-te-lora.json").write_text('{"image_rel_l2": 0.1}')
    c = shrink(spec.cell("gen-te-lora", bench, tmp_path))
    res = bench_run.run_cell(c, SEED, 0.2, False, "cpu", time.perf_counter())
    assert res["correct"] and set(res["metrics"]) == {"gen_img_per_s", "setup_s"}
    assert {m["name"] for m in c["per_layer"]} >= {"mfu.gen", "jpeg_write_share.gen"}


def test_full_width_modules_are_named_and_shaped_alike():
    from fairdiff_torch.models.autoencoder_kl import AutoencoderKL
    from fairdiff_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from fairdiff_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
    from fairdiff_torch.models.dinov2 import DINOv2Config, DINOv2Model
    from fairdiff_torch.models.face_detector import DetectorConfig, FaceDetectorNet
    from fairdiff_torch.models.mobilenet_v3 import MobileNetV3Large
    from fairdiff_torch.models.sfnet import SFNet, SFNetConfig
    from fairdiff_torch.models.unet2d import UNet2DCondition

    from benchmark.harness import models
    from benchmark.harness.spec import cell, load_bench

    w = models.Weights(cell("train-exp1", load_bench())["config"], 0, "meta", torch.bfloat16)
    with torch.device("meta"):
        port = {"text_encoder": CLIPTextModel(CLIPTextConfig.sd15()), "unet": UNet2DCondition(),
                "vae": AutoencoderKL(), "detector": FaceDetectorNet(DetectorConfig()),
                "classifier": MobileNetV3Large(80), "clip": CLIPVisionModel(CLIPVisionConfig.vit_h14()),
                "dino": DINOv2Model(DINOv2Config.vitb14()), "face": SFNet(SFNetConfig.sfnet20())}
    ours = {**w.sd.models(), **w.zoo}
    shapes = lambda m: {k: tuple(p.shape) for k, p in m.named_parameters()}
    for name, module in port.items():
        assert shapes(ours[name]) == shapes(module), name
