"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: the tiny
SD, the tiny zoo, fp32, rank 2, few lanes and steps. Only the tests use it;
the benchmark's cells run at their configuration's size."""

from __future__ import annotations

import copy

from benchmark.harness.spec import cell, load_bench


def tiny_cell(name: str, config: str = "", traffic: str = "", limits: str = "") -> dict:
    """The cell `name` of BENCHMARK.json at the tiny size; or, given a
    configuration and a traffic mix, a cell the benchmark does not list,
    held to the limits of the cell `limits`."""
    bench = load_bench()
    if config:
        bench["workloads"].append({"name": limits, "config": config, "traffic": traffic, "chips": 1, "why": name})
        name = limits
    return shrink(cell(name, bench))


def shrink(c: dict) -> dict:
    c = copy.deepcopy(c)
    c["config"].update(sd="tiny", dtype="float32")
    c["config"]["zoo"].update(tiny=True, chip_size=32, aligned_size=32, img_size_small=32, face_db_rows=8)
    c["config"]["lora"]["rank"] = 2
    c["config"]["debias"]["lora_rank"] = 2
    if c["traffic"]["kind"] == "train":
        c["traffic"].update(lanes=4, micro_batch=2, denoising_steps=[2, 4])
    else:
        c["traffic"].update(batch=2, denoising_steps=2, images_per_prompt=4, reference_images=2)
    return c
