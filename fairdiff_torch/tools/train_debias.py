"""Fairness-finetuning CLI, exp-1 (counterpart of
fairdiff/tools/train_debias.py).

Runs SD-1.5 at full width (or the tiny config) on seeded random weights,
with the guidance stack of `--guidance_dir` (`training.model_zoo`, frozen
weights in the SD dtype) or, without one, the synthetic stack, as the JAX
CLI does. `--flash_bwd merged` sends the UNet's flash backward through K6
instead of K2 + K3. Prints one JSON log line per step and saves the adapters
and their EMA as `.npz` under `<output_dir>/exported/`.

Usage:
  python -m fairdiff_torch.tools.train_debias --max_train_steps 2
  python -m fairdiff_torch.tools.train_debias --device cpu --tiny_smoke 1 \
      --max_train_steps 2 --output_dir outputs/debias [--guidance_dir DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import typing
from pathlib import Path

import numpy as np
import torch

from fairdiff_torch.io.adapters_io import save_adapters
from fairdiff_torch.io.prompts import load_occupation_prompts
from fairdiff_torch.io.tokenizer import load_tokenizer
from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion
from fairdiff_torch.training.debias import DebiasState, DebiasTrainer
from fairdiff_torch.training.model_zoo import load_guidance_stack
from fairdiff_torch.training.presets import PRESETS
from fairdiff_torch.training.synthetic import synthetic_stack

# the JAX CLI's prompts when no --prompts_json is given
DEFAULT_PROMPTS = (
    "a photo of the face of a doctor, a person",
    "a photo of the face of a firefighter, a person",
)


@dataclasses.dataclass(frozen=True)
class TrainCLIConfig:
    device: str = ""  # "" = cuda; "cpu" only when asked for
    experiment: str = "exp1"
    sd_config: str = "sd15"  # "sd15" or "tiny"
    tiny_smoke: bool = False  # tiny model and a 2-step, 4-lane step on the CPU
    prompts_json: str = ""
    guidance_dir: str = ""  # "" = the synthetic stack
    flash_bwd: str = "split"  # the UNet's flash backward: "split" (K2 + K3) or "merged" (K6)
    output_dir: str = "outputs/debias"
    seed: int = 42
    # overrides of the preset (0 = the preset's value)
    max_train_steps: int = 0
    train_images_per_prompt: int = 0
    train_micro_batch: int = 0
    steps: int = 0  # fixes the denoising step count (steps_low = steps_high)


def build_trainer(cfg: TrainCLIConfig) -> DebiasTrainer:
    overrides: dict[str, typing.Any] = {"seed": cfg.seed}
    for field in ("max_train_steps", "train_images_per_prompt", "train_micro_batch"):
        if getattr(cfg, field):
            overrides[field] = getattr(cfg, field)
    if cfg.steps:
        overrides.update(steps_low=cfg.steps, steps_high=cfg.steps)
    dcfg = PRESETS[cfg.experiment](**overrides)
    if cfg.tiny_smoke:
        sd = StableDiffusion(SDConfig.tiny(), device=cfg.device or None, flash_bwd=cfg.flash_bwd)
        dcfg = dataclasses.replace(
            dcfg, steps_low=2, steps_high=2,
            train_images_per_prompt=min(dcfg.train_images_per_prompt, 4),
            train_micro_batch=2, lora_rank=2,
        )
    else:
        arch = {"sd15": SDConfig.sd15, "tiny": SDConfig.tiny}[cfg.sd_config]()
        sd = StableDiffusion(arch, device=cfg.device or None, remat=cfg.sd_config != "tiny",
                             flash_bwd=cfg.flash_bwd)
    sd.init_random(cfg.seed)
    if cfg.guidance_dir:
        guidance = load_guidance_stack(cfg.guidance_dir, dcfg.attributes, dtype=sd.dtype, device=sd.device)
    else:
        guidance = synthetic_stack(dcfg.attributes, device=sd.device)
    return DebiasTrainer(sd, guidance, dcfg)


def tokenize_prompts(sd: StableDiffusion, tokenizer, prompts: list[str]) -> list[tuple]:
    max_len = min(tokenizer.model_max_length, sd.config.text.max_position_embeddings)
    uncond = torch.as_tensor(tokenizer([""], padding="max_length", max_length=max_len).input_ids)
    return [
        (torch.as_tensor(tokenizer([p], padding="max_length", max_length=max_len).input_ids), uncond)
        for p in prompts
    ]


def main(cfg: TrainCLIConfig) -> DebiasState:
    trainer = build_trainer(cfg)
    sd, dcfg = trainer.sd, trainer.cfg
    tokenizer = load_tokenizer(None)
    if cfg.tiny_smoke or cfg.sd_config == "tiny":
        tokenizer.vocab_size = sd.config.text.vocab_size
        tokenizer.bos_token_id = 0
        tokenizer.eos_token_id = sd.config.text.vocab_size - 1
        tokenizer.pad_token_id = sd.config.text.vocab_size - 1
    prompts = (
        load_occupation_prompts(cfg.prompts_json)["train_prompts"] if cfg.prompts_json
        else list(DEFAULT_PROMPTS)
    )
    train_ids = tokenize_prompts(sd, tokenizer, prompts)

    state = trainer.init_state(cfg.seed)
    # the same prompt order as the JAX trainer's `fit` (seed + 1 permutations)
    order_rng = np.random.default_rng(dcfg.seed + 1)
    order: list[int] = []
    while state.step < dcfg.max_train_steps:
        if not order:
            order = order_rng.permutation(len(train_ids)).tolist()
        t0 = time.perf_counter()
        state, logs = trainer.train_step(state, train_ids[order.pop(0)])
        logs["step_time_s"] = time.perf_counter() - t0
        logs.update({f"time_{k}_s": v for k, v in trainer.timers.last.items()})
        print(json.dumps({"step": state.step, **logs}), flush=True)

    export_dir = Path(cfg.output_dir) / "exported"
    for name, tree in state.adapters.items():
        save_adapters(export_dir / f"{name}.npz", tree)
        save_adapters(export_dir / f"{name}_EMA.npz", state.ema[name])
    print(f"[train] done at step {state.step}; adapters -> {export_dir}", flush=True)
    return state


def parse_args(argv: list[str] | None = None) -> TrainCLIConfig:
    """`--field value` for every field of TrainCLIConfig."""
    hints = typing.get_type_hints(TrainCLIConfig)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for f in dataclasses.fields(TrainCLIConfig):
        kind = hints[f.name]
        conv = (lambda s: s.lower() in ("1", "true", "yes", "on")) if kind is bool else kind
        parser.add_argument(f"--{f.name}", type=conv, default=f.default)
    return TrainCLIConfig(**vars(parser.parse_args(argv)))


if __name__ == "__main__":
    main(parse_args())
