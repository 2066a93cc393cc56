"""Batch image generation CLI (counterpart of fairdiff/tools/gen_images.py).

Reproduces the reference gen-images behaviour: a deterministic noise bank
per (seed, prompt, image index), optional TE-LoRA / UNet-LoRA / soft-prefix
adapters from `.npz`, skip-existing resume, `prompt_i/img_j.png` outputs,
and the reference defaults (30 steps, batch 10, guidance 7.5, 60 images a
prompt). Without a checkpoint it runs SD-1.5 at full width on seeded random
weights.

Usage:
  python -m fairdiff_torch.tools.gen_images --save_dir outputs/gen --num_imgs_per_prompt 4
  python -m fairdiff_torch.tools.gen_images --tiny_smoke 1 --device cpu \
      --num_imgs_per_prompt 2 --batch_size 2 --num_denoising_steps 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import typing
from pathlib import Path

import torch

from fairdiff_torch.adapters.prefix import prepend_prefix_ids
from fairdiff_torch.io.adapters_io import load_adapters
from fairdiff_torch.io.images import save_png
from fairdiff_torch.io.tokenizer import load_tokenizer
from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion
from fairdiff_torch.utils.rng import prompt_noise_generator


@dataclasses.dataclass(frozen=True)
class GenImagesConfig:
    device: str = ""  # "" = cuda; "cpu" only when asked for
    tokenizer_dir: str = ""
    load_text_encoder_lora_from: str = ""
    load_unet_lora_from: str = ""
    load_prefix_embedding_from: str = ""
    num_prefix_tokens: int = 5
    # prompts
    prompts_json: str = ""
    prompts_key: str = "test_prompts"
    prompt: str = "a photo of the face of a firefighter, a person"
    # generation (reference defaults)
    num_imgs_per_prompt: int = 60
    batch_size: int = 10
    num_denoising_steps: int = 30
    guidance_scale: float = 7.5
    random_seed: int = 42
    save_dir: str = "outputs/gen-images"
    tiny_smoke: bool = False  # tiny random model for CPU smoke runs


def main(cfg: GenImagesConfig) -> list[Path]:
    sd_cfg = SDConfig.tiny() if cfg.tiny_smoke else SDConfig.sd15()
    sd = StableDiffusion(sd_cfg, device=cfg.device or None).init_random(cfg.random_seed)
    tokenizer = load_tokenizer(cfg.tokenizer_dir or None)
    if cfg.tiny_smoke:
        tokenizer.vocab_size = sd_cfg.text.vocab_size
        tokenizer.bos_token_id = 0
        tokenizer.eos_token_id = sd_cfg.text.vocab_size - 1
        tokenizer.pad_token_id = sd_cfg.text.vocab_size - 1

    unet_lora = load_adapters(cfg.load_unet_lora_from) if cfg.load_unet_lora_from else None
    te_lora = (
        load_adapters(cfg.load_text_encoder_lora_from)
        if cfg.load_text_encoder_lora_from else None
    )
    prefix_table = None
    if cfg.load_prefix_embedding_from:
        prefix_table = torch.tensor(load_adapters(cfg.load_prefix_embedding_from)["prefix"])

    if cfg.prompts_json:
        with open(cfg.prompts_json) as f:
            prompts = json.load(f)[cfg.prompts_key]
    else:
        prompts = [cfg.prompt]

    max_len = min(tokenizer.model_max_length, sd_cfg.text.max_position_embeddings)
    latent = sd.latent_shape(1)[1:]
    written: list[Path] = []
    for pi, prompt in enumerate(prompts):
        prompt_dir = Path(cfg.save_dir) / f"prompt_{pi}"
        todo = [
            j for j in range(cfg.num_imgs_per_prompt)
            if not (prompt_dir / f"img_{j}.png").exists()  # resume
        ]
        if not todo:
            continue
        cond_ids = torch.as_tensor(
            tokenizer([prompt], padding="max_length", max_length=max_len).input_ids
        )
        uncond_ids = torch.as_tensor(
            tokenizer([""], padding="max_length", max_length=max_len).input_ids
        )
        if prefix_table is not None:
            # masks come from the ids (eos_attention_mask), so they stay
            # right for the shifted sequence
            cond_ids = prepend_prefix_ids(
                cond_ids, cfg.num_prefix_tokens, sd_cfg.text.vocab_size, max_len
            )

        t0 = time.perf_counter()
        for start in range(0, len(todo), cfg.batch_size):
            chunk = todo[start : start + cfg.batch_size]
            noises = torch.stack(
                [torch.randn(latent, generator=prompt_noise_generator(cfg.random_seed, prompt, j))
                 for j in chunk]
            )
            imgs = sd.generate(
                noises, cond_ids, uncond_ids, cfg.num_denoising_steps,
                unet_lora=unet_lora, te_lora=te_lora, prefix_table=prefix_table,
                guidance_scale=cfg.guidance_scale,
            )
            for j, img in zip(chunk, imgs.cpu().numpy()):
                out = prompt_dir / f"img_{j}.png"
                save_png(img, out)
                written.append(out)
        dt = time.perf_counter() - t0
        print(
            f"[gen-images] prompt {pi}: {len(todo)} imgs in {dt:.1f}s "
            f"({len(todo) / dt:.2f} img/s) -> {prompt_dir}"
        )
    return written


def parse_args(argv: list[str] | None = None) -> GenImagesConfig:
    """`--field value` for every field of GenImagesConfig."""
    hints = typing.get_type_hints(GenImagesConfig)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for f in dataclasses.fields(GenImagesConfig):
        kind = hints[f.name]
        conv = (lambda s: s.lower() in ("1", "true", "yes", "on")) if kind is bool else kind
        parser.add_argument(f"--{f.name}", type=conv, default=f.default)
    return GenImagesConfig(**vars(parser.parse_args(argv)))


if __name__ == "__main__":
    main(parse_args())
