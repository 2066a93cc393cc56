"""Fairness-finetuning CLI, exp-1 to exp-6 (counterpart of
fairdiff/tools/train_debias.py).

Runs SD-1.5 at full width (or the tiny config) on the weights of
`--model_dir` (`tools/convert_sd`'s store) or, without one, on seeded random
weights, with the guidance stack of `--guidance_dir` (`training.model_zoo`,
`tools/convert_guidance`'s layout, frozen weights in the SD dtype) or,
without one, the synthetic stack, as the JAX CLI does. `--experiment` picks the preset; exp-5 mixes the prompt files of
`--multi_prompts_json` (comma-separated) with `--multi_prompts_repeats`.
`--flash_bwd merged` sends the UNet's flash backward through K6 instead of
K2 + K3, and `--flash_bwd recompute` through the plain attention's autograd
(the forward runs K1 without lse). `--tokenizer_dir` reads a CLIP tokenizer
directory (`vocab.json`, `merges.txt`) with the port's own BPE; without it a
hash tokenizer stands in, which a real text encoder cannot read.
`--profile_steps N` first runs N steps under `torch.profiler` and writes
their Chrome trace to `<output_dir>/trace` (`python -m
fairdiff_torch.utils.trace_summary <output_dir>/trace` sums it by kernel). `--debias_config FILE` merges a YAML file onto the preset's
`DebiasConfig` (e.g. `train_unet: true`; unknown keys raise), and `--config
FILE` sets this CLI's own fields the same way.

The run (`DebiasTrainer.fit`) logs every step, and every `eval_interval`
steps the evaluation of the adapters and of their EMA, to
`<output_dir>/metrics.jsonl` and as JSON lines on stdout (and to wandb with
`--use_wandb 1` where it can start); the evaluation grids go to
`<output_dir>/imgs/`. It checkpoints to `<output_dir>/checkpoints/` on the
dual cadence (`--checkpoint_tmp_every`, `--checkpoint_perm_every`);
`--resume_from_checkpoint 1` continues from the latest one with the same
prompt order. At the end it saves the adapters and their EMA as `.npz`
under `<output_dir>/exported/` (exp-2's prefix table as `prefix.npz` with
key `prefix`, which `gen_images --load_prefix_embedding_from` reads).

Usage:
  python -m fairdiff_torch.tools.train_debias --experiment exp3 --max_train_steps 2
  python -m fairdiff_torch.tools.train_debias --model_dir converted-sd15 --guidance_dir converted-guidance
  python -m fairdiff_torch.tools.train_debias --device cpu --tiny_smoke 1 \
      --experiment exp2 --max_train_steps 2 --output_dir outputs/debias [--guidance_dir DIR]
  python -m fairdiff_torch.tools.train_debias --device cpu --tiny_smoke 1 --max_train_steps 4 \
      --debias_config run.yaml --resume_from_checkpoint 1 --checkpoint_tmp_every 2
"""

from __future__ import annotations

import dataclasses
import json
import time
import typing
from pathlib import Path

import torch

from fairdiff_torch.io.adapters_io import save_adapters
from fairdiff_torch.io.prompts import load_multi_domain_prompts, load_occupation_prompts
from fairdiff_torch.io.reference_adapters import REFERENCE_FILES
from fairdiff_torch.io.tokenizer import load_tokenizer
from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion
from fairdiff_torch.training.checkpoints import DualCadenceCheckpointer
from fairdiff_torch.training.debias import DebiasConfig, DebiasState, DebiasTrainer
from fairdiff_torch.training.logging import MetricsLogger
from fairdiff_torch.training.model_zoo import load_guidance_stack
from fairdiff_torch.training.presets import PRESETS
from fairdiff_torch.training.synthetic import synthetic_stack
from fairdiff_torch.utils import config as cfglib
from fairdiff_torch.utils.profiling import trace_to

# the JAX CLI's prompts when no --prompts_json is given
DEFAULT_PROMPTS = (
    "a photo of the face of a doctor, a person",
    "a photo of the face of a firefighter, a person",
)


@dataclasses.dataclass(frozen=True)
class TrainCLIConfig:
    device: str = ""  # "" = cuda; "cpu" only when asked for
    experiment: str = "exp1"
    sd_config: str = "sd15"  # "sd15" or "tiny": the architecture --model_dir holds
    model_dir: str = ""  # converted SD weights (tools/convert_sd); "" = seeded random weights
    tokenizer_dir: str = ""  # a CLIP tokenizer directory; "" = the hash tokenizer
    tiny_smoke: bool = False  # tiny model and a 2-step, 4-lane step on the CPU
    prompts_json: str = ""
    # exp-5's domain mixing: comma-separated prompt files and their repeats
    multi_prompts_json: str = ""
    multi_prompts_repeats: str = "1,6,20,4"
    guidance_dir: str = ""  # "" = the synthetic stack
    # the UNet's flash backward: "split" (K2 + K3), "merged" (K6) or "recompute" (plain attention)
    flash_bwd: str = "split"
    output_dir: str = "outputs/debias"
    # a YAML file merged onto the preset's DebiasConfig
    debias_config: str = ""
    resume_from_checkpoint: bool = False
    use_wandb: bool = False
    seed: int = 42
    # overrides of the preset (0 = the preset's value)
    max_train_steps: int = 0
    train_images_per_prompt: int = 0
    train_micro_batch: int = 0
    eval_interval: int = 0
    steps: int = 0  # fixes the denoising step count (steps_low = steps_high)
    checkpoint_tmp_every: int = 20
    checkpoint_perm_every: int = 200
    # >0: a torch.profiler trace of the first N steps to <output_dir>/trace
    profile_steps: int = 0


def debias_config(cfg: TrainCLIConfig) -> DebiasConfig:
    """The preset with the CLI's overrides, then the YAML file of
    `debias_config`, then (`tiny_smoke`) the tiny run's sizes."""
    overrides: dict[str, typing.Any] = {"seed": cfg.seed, "output_dir": cfg.output_dir}
    for field in ("max_train_steps", "train_images_per_prompt", "train_micro_batch", "eval_interval"):
        if getattr(cfg, field):
            overrides[field] = getattr(cfg, field)
    if cfg.steps:
        overrides.update(steps_low=cfg.steps, steps_high=cfg.steps)
    dcfg = PRESETS[cfg.experiment](**overrides)
    if cfg.debias_config:
        dcfg = cfglib.load_yaml(dcfg, cfg.debias_config)
    if cfg.tiny_smoke:
        dcfg = dataclasses.replace(
            dcfg, steps_low=2, steps_high=2,
            train_images_per_prompt=min(dcfg.train_images_per_prompt, 4),
            train_micro_batch=2, val_images_per_prompt=2, eval_denoising_steps=2, lora_rank=2,
        )
    return dcfg


def sd_config(cfg: TrainCLIConfig) -> SDConfig:
    return SDConfig.tiny() if cfg.tiny_smoke else {"sd15": SDConfig.sd15, "tiny": SDConfig.tiny}[cfg.sd_config]()


def build_trainer(cfg: TrainCLIConfig) -> DebiasTrainer:
    """The trainer on the SD weights of `model_dir` (else seeded random
    ones) and the guidance stack of `guidance_dir` (else the synthetic one);
    remat at SD-1.5 width."""
    dcfg = debias_config(cfg)
    remat = not cfg.tiny_smoke and cfg.sd_config != "tiny"
    sd = StableDiffusion(sd_config(cfg), device=cfg.device or None, remat=remat, flash_bwd=cfg.flash_bwd)
    if cfg.model_dir:
        t0 = time.perf_counter()
        sd.load_params(cfg.model_dir)
        print(f"[train] loaded {cfg.model_dir} in {time.perf_counter() - t0:.1f} s", flush=True)
    else:
        if not cfg.tiny_smoke:
            print("[train] WARNING: no --model_dir; random-init SD weights", flush=True)
        sd.init_random(cfg.seed)
    if cfg.guidance_dir:
        guidance = load_guidance_stack(cfg.guidance_dir, dcfg.attributes, dtype=sd.dtype, device=sd.device)
    else:
        if not cfg.tiny_smoke:
            print("[train] WARNING: no --guidance_dir; synthetic guidance", flush=True)
        guidance = synthetic_stack(dcfg.attributes, device=sd.device)
    return DebiasTrainer(sd, guidance, dcfg)


def tokenize_prompts(sd: StableDiffusion, tokenizer, prompts: list[str]) -> list[tuple]:
    max_len = min(tokenizer.model_max_length, sd.config.text.max_position_embeddings)
    uncond = torch.as_tensor(tokenizer([""], padding="max_length", max_length=max_len).input_ids)
    return [
        (torch.as_tensor(tokenizer([p], padding="max_length", max_length=max_len).input_ids), uncond)
        for p in prompts
    ]


def export_adapters(state: DebiasState, out_dir: str | Path, reference_format: bool = False) -> None:
    """Each adapter and its EMA as `<name>.npz` and `<name>_EMA.npz` (a bare
    prefix table under the key `prefix`), and with `reference_format` also
    the reference's `<stem>.pth` and `<stem>_EMA.pth`."""
    out_dir = Path(out_dir)
    wrap = lambda t: t if isinstance(t, dict) else {"prefix": t}
    for name, tree in state.adapters.items():
        save_adapters(out_dir / f"{name}.npz", wrap(tree))
        save_adapters(out_dir / f"{name}_EMA.npz", wrap(state.ema[name]))
        if reference_format:
            stem, to_state_dict = REFERENCE_FILES[name]
            torch.save(to_state_dict(tree), out_dir / f"{stem}.pth")
            torch.save(to_state_dict(state.ema[name]), out_dir / f"{stem}_EMA.pth")


def main(cfg: TrainCLIConfig, trainer: DebiasTrainer | None = None) -> DebiasState:
    """Train to `max_train_steps` (from the latest checkpoint with
    `resume_from_checkpoint`) and export the adapters; `trainer` is
    `build_trainer(cfg)` unless given."""
    trainer = trainer or build_trainer(cfg)
    sd, dcfg = trainer.sd, trainer.cfg
    tokenizer = load_tokenizer(cfg.tokenizer_dir or None)
    if cfg.tiny_smoke or cfg.sd_config == "tiny":
        tokenizer.vocab_size = sd.config.text.vocab_size
        tokenizer.bos_token_id = 0
        tokenizer.eos_token_id = sd.config.text.vocab_size - 1
        tokenizer.pad_token_id = sd.config.text.vocab_size - 1
    # validation prompts as the JAX CLI picks them: the file's, else the
    # first 4 training prompts (the first one without a file)
    val_prompts, n_val = None, 1
    if cfg.multi_prompts_json:
        repeats = [int(r) for r in cfg.multi_prompts_repeats.split(",")]
        data = load_multi_domain_prompts(cfg.multi_prompts_json.split(","), repeats)
        prompts, val_prompts, n_val = data["train_prompts"], data["val_prompts"] or None, 4
    elif cfg.prompts_json:
        data = load_occupation_prompts(cfg.prompts_json)
        prompts, val_prompts, n_val = data["train_prompts"], data.get("val_prompts"), 4
    else:
        prompts = list(DEFAULT_PROMPTS)
    train_ids = tokenize_prompts(sd, tokenizer, prompts)
    if val_prompts is not None:
        val_ids = tokenize_prompts(sd, tokenizer, val_prompts)
    else:
        val_prompts, val_ids = prompts[:n_val], train_ids[:n_val]

    metrics = MetricsLogger(cfg.output_dir, use_wandb=cfg.use_wandb, run_name=cfg.experiment,
                            config=cfglib.to_dict(dcfg))

    def log(step: int, logs: dict) -> None:
        metrics(step, logs)
        print(json.dumps({"step": step, **logs}), flush=True)

    trainer.logger = log
    ckpt = DualCadenceCheckpointer(Path(cfg.output_dir) / "checkpoints", tmp_every=cfg.checkpoint_tmp_every,
                                   perm_every=cfg.checkpoint_perm_every)
    state = trainer.init_state(cfg.seed)
    if cfg.resume_from_checkpoint and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        print(f"[train] resumed from step {state.step}", flush=True)
    if cfg.profile_steps > 0:
        with trace_to(Path(cfg.output_dir) / "trace", device=sd.device):
            state = trainer.fit(state, train_ids, max_steps=state.step + cfg.profile_steps)
        print(f"[train] trace written to {Path(cfg.output_dir) / 'trace'}", flush=True)
    state = trainer.fit(state, train_ids, val_prompt_ids=val_ids, checkpoint_cb=ckpt.maybe_save,
                        val_prompt_texts=val_prompts)
    ckpt.close()

    export_dir = Path(cfg.output_dir) / "exported"
    export_adapters(state, export_dir)
    print(f"[train] done at step {state.step}; adapters -> {export_dir}", flush=True)
    metrics.close()
    return state


def parse_args(argv: list[str] | None = None) -> TrainCLIConfig:
    """`--field value` for every field of TrainCLIConfig, after `--config
    FILE` (a YAML file of such fields)."""
    return cfglib.cli_parse(TrainCLIConfig, argv)


if __name__ == "__main__":
    main(parse_args())
