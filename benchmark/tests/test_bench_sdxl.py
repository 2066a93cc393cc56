"""The SDXL cell, `gen-sdxl-unet-lora`, on the CPU: found by name through its
files and entries alone (`configs/sdxl-unet-lora.json`,
`traffic/sdxl-protocol-gen.json`, `limits/gen-sdxl-unet-lora.json`,
`drivers/gen_sdxl.py`, four readers); a whole run at the tiny size of SDXL's
topology (set-up, window, reference) at rounding level; its per-layer
readers reading numbers from the run's record with a synthetic device trace
(the flash roofline's operations only at full width, counted there);
the reference's modules named and shaped as the program's at full width;
and its configuration the program's `SDConfig.sdxl()`."""

from __future__ import annotations

import copy
import dataclasses
import time

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import spec
from benchmark.harness.trace import TraceResult

CELL = "gen-sdxl-unet-lora"
SEED = 2**31 + 9191
READERS = ("mfu.gen_sdxl", "flash_roofline.gen_sdxl", "geglu_roofline.gen_sdxl", "deep_stack_ms.gen_sdxl")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_sdxl_cell() -> dict:
    """The cell at `SDConfig.tiny_xl()`'s size: fp32, rank 2, batch 2, two
    denoising steps, two reference images."""
    c = copy.deepcopy(spec.cell(CELL, spec.load_bench()))
    c["config"].update(sd="tiny", dtype="float32")
    c["config"]["lora"]["rank"] = 2
    c["traffic"].update(batch=2, denoising_steps=2, images_per_prompt=4, reference_images=2)
    return c


def test_the_cell_is_found_by_its_files_and_entries():
    bench = spec.load_bench()
    c = spec.cell(CELL, bench)
    assert c["workload"]["chips"] == 1 and c["traffic"]["kind"] == "gen_sdxl"
    assert hasattr(spec.driver("gen_sdxl"), "run")
    assert c["limits"] == {"image_rel_l2": c["limits"]["image_rel_l2"]} and c["limits"]["image_rel_l2"] > 0
    assert {m["name"] for m in c["end_to_end"]} == {"gen_img_per_s", "setup_s"}
    assert {m["name"] for m in c["per_layer"]} == set(READERS)
    for m in c["per_layer"]:
        assert callable(spec.metric_reader(m["name"])) and m["moves"] == "gen_img_per_s"
    gen = spec.read_json(spec.ROOT / "benchmark" / "traffic" / "protocol-gen.json")
    assert {k: v for k, v in c["traffic"].items() if k not in ("kind", "why")} == {
        k: v for k, v in gen.items() if k not in ("kind", "why")}


def test_the_configuration_is_the_programs_sdxl():
    from fairdiff_torch.sampling.pipeline import SDConfig

    data = spec.cell(CELL, spec.load_bench())["config"]
    sd = SDConfig.sdxl()
    assert data["sd"] == "sdxl" and data["reduced"] == [] and data["dtype"] == sd.dtype
    for key, ours in (("text_encoder", sd.text), ("text_encoder_2", sd.text_2), ("unet", sd.unet), ("vae", sd.vae)):
        theirs = {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(ours).items()}
        assert data[key] == theirs, key
    assert data["lora"] == {"target": "unet", "rank": 50}


def test_tiny_run_is_correct_and_at_rounding_level():
    res = bench_run.run_cell(tiny_sdxl_cell(), SEED, 0.2, False, "cpu", time.perf_counter())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    for name, (value, limit) in res["checks"].items():
        assert value < 1e-4, (name, value)  # fp32 on both sides, other summation orders
    assert set(res["metrics"]) == {"gen_img_per_s", "setup_s"}


def test_the_readers_read_a_traced_tiny_record():
    from benchmark.drivers import gen_sdxl

    c = tiny_sdxl_cell()
    ctx = bench_run.Context(c, SEED, 0.2, False, "cpu", time.perf_counter())
    record = gen_sdxl.run(ctx)["record"]
    assert record.kind == "gen_sdxl" and record.work
    t0, t1 = record.window_ns
    third = (t1 - t0) // 3
    events = [("qb::flash_fwd_kernel<64>", t0, t0 + third), ("k4::fwd_kernel<128, 128>", t0 + third, t1 - third)]
    traced = dataclasses.replace(record, trace=TraceResult(events, t0, t1, record.spans.items))
    values = {name: spec.metric_reader(name)(traced) for name in READERS}
    # the tiny 8x8 latent has no self-attention over FLASH_MIN_KV keys: nothing for the flash roofline
    assert values.pop("flash_roofline.gen_sdxl") is None
    assert all(isinstance(v, float) and v > 0 for v in values.values()), values
    assert all(spec.metric_reader(name)(record) is None for name in READERS)  # untraced: nothing to read
    other = dataclasses.replace(traced, kind="gen")
    assert all(spec.metric_reader(name)(other) is None for name in READERS)


def test_full_width_reference_is_named_and_shaped_as_the_program():
    from fairdiff_torch.models.autoencoder_kl import AutoencoderKL
    from fairdiff_torch.models.clip_text import CLIPTextModel
    from fairdiff_torch.models.unet2d import UNet2DCondition
    from fairdiff_torch.sampling.pipeline import SDConfig

    from benchmark.drivers.gen_sdxl import Weights

    w = Weights(spec.cell(CELL, spec.load_bench())["config"], 0, "meta", torch.bfloat16)
    sd = SDConfig.sdxl()
    with torch.device("meta"):
        port = {"text_encoder": CLIPTextModel(sd.text), "text_encoder_2": CLIPTextModel(sd.text_2),
                "unet": UNet2DCondition(sd.unet), "vae": AutoencoderKL(sd.vae)}
    shapes = lambda m: {k: tuple(p.shape) for k, p in m.named_parameters()}
    for name, module in port.items():
        assert shapes(w.sd.models()[name]) == shapes(module), name


def test_unit_flops_and_operations_at_full_width():
    """The counts the readers use, at the configuration's 1024 px: a UNet row
    of 5.9-7 TFLOP, most of it in the 1280-channel stacks; 70 flash-attention
    operations at D = 64 (10 at 4096 tokens, 60 at 1024) and 70 GEGLUs."""
    from benchmark.metrics import _sdxl

    config = spec.cell(CELL, spec.load_bench())["config"]
    ops = _sdxl.unet_ops(config)
    assert sorted(set(ops["flash"])) == [(1024, 1024, 20, 64), (4096, 4096, 10, 64)]
    assert [len([o for o in ops["flash"] if o[0] == s]) for s in (4096, 1024)] == [10, 60]
    assert sorted(set(ops["geglu"])) == [(1024, 1280, 5120), (4096, 640, 2560)]
    f = _sdxl._count_unit_flops(config)
    assert 5.9e12 < f["unet"] < 7e12 and f["te"] > 0 and f["decode"] > 0


PARENT_RUN = """
import os, subprocess, sys, threading, time
from types import SimpleNamespace
from benchmark.drivers import gen_sdxl
from benchmark.harness import spec
from fairdiff_torch.sampling import pipeline

# a background build as the harness starts one: a thread whose compiler has children of its own
threading.Thread(target=subprocess.run, args=(["sh", "-c", "sleep 120 & sleep 120"],)).start()
deadline = time.perf_counter() + 10
while len(gen_sdxl.descendants(os.getpid())) < 2 and time.perf_counter() < deadline:
    time.sleep(0.02)
print(" ".join(map(str, sorted(gen_sdxl.descendants(os.getpid())))), flush=True)
del pipeline.SDConfig.sdxl  # a program that cannot run SDXL
cell = spec.cell("gen-sdxl-unet-lora", spec.load_bench())
gen_sdxl.run(SimpleNamespace(cell=cell, device="cpu", spans=None))
print("ran on", flush=True)
"""


def test_a_program_without_sdxl_exits_at_once_and_leaves_no_process():
    """On a program without `SDConfig.sdxl` the driver exits with code 1 in
    seconds, while the kernels' background build still runs; that build's
    processes, its compilers' own children too, end with it, and the shell
    that ran it goes on."""
    import os
    import subprocess
    import sys

    # In a session of its own, under a shell of its process group: the group is orphaned, as
    # under a runner that starts the command with setsid, and the shell must outlive the run.
    t0 = time.perf_counter()
    p = subprocess.run(["bash", "-c", '"$0" -c "$1"; echo "shell saw $?"', sys.executable, PARENT_RUN],
                       cwd=spec.ROOT, capture_output=True, text=True, timeout=90, start_new_session=True)
    assert p.returncode == 0 and p.stdout.splitlines()[-1] == "shell saw 1", (p.stdout, p.stderr)
    assert time.perf_counter() - t0 < 60
    assert "no SDConfig.sdxl" in p.stderr and "ran on" not in p.stdout
    pids = [int(x) for x in p.stdout.splitlines()[0].split()]
    assert len(pids) >= 2  # sh and its two sleeps
    for pid in pids:
        try:
            state = open(f"/proc/{pid}/stat").read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue  # gone
        assert state == "Z", (pid, state)  # dead, waiting only for its new parent to reap it
