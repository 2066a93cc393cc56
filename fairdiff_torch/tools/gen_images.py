"""Batch image generation CLI (counterpart of fairdiff/tools/gen_images.py).

Reproduces the reference gen-images behaviour: a deterministic noise bank
per (seed, prompt, image index), optional TE-LoRA / UNet-LoRA / soft-prefix
adapters from `.npz` or from the reference's exported `.pth` (`.pt`, `.bin`)
files, skip-existing resume, `prompt_i/img_j.jpg` outputs (JPEG at quality 95),
and the reference defaults (30 steps, batch 10, guidance 7.5, 60 images a
prompt). `--model_dir` reads the weights that `tools/convert_sd` wrote;
without it the model runs at full width on seeded random weights.
`--preset` names the architecture as `convert_sd --preset` does: "sd15"
(the default) or "sdxl" (SDXL base 1.0 at 1024 px: both of its text
encoders take the one tokenizer's ids, padded with eos); `--tiny_smoke 1`
runs the preset's CPU miniature. The protocol is the same for both.

Usage:
  python -m fairdiff_torch.tools.convert_sd --sd_dir /path/sd15 --out_dir converted-sd15
  python -m fairdiff_torch.tools.gen_images --model_dir converted-sd15 --save_dir outputs/gen
  python -m fairdiff_torch.tools.convert_sd --sd_dir /path/sdxl --out_dir converted-sdxl --preset sdxl
  python -m fairdiff_torch.tools.gen_images --preset sdxl --model_dir converted-sdxl --save_dir outputs/gen-xl
  python -m fairdiff_torch.tools.gen_images --tiny_smoke 1 --device cpu \
      --num_imgs_per_prompt 2 --batch_size 2 --num_denoising_steps 2
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import torch

from fairdiff_torch.adapters.prefix import prepend_prefix_ids
from fairdiff_torch.io.adapters_io import load_adapters
from fairdiff_torch.io.images import save_image
from fairdiff_torch.io.reference_adapters import load_reference_adapters
from fairdiff_torch.io.tokenizer import load_tokenizer
from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion
from fairdiff_torch.utils import config as cfglib
from fairdiff_torch.utils.rng import prompt_noise_generator


@dataclasses.dataclass(frozen=True)
class GenImagesConfig:
    device: str = ""  # "" = cuda; "cpu" only when asked for
    model_dir: str = ""  # converted SD weights (tools/convert_sd); "" = seeded random weights
    preset: str = "sd15"  # the architecture: "sd15" or "sdxl" (convert_sd's --preset)
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
    tiny_smoke: bool = False  # the preset's tiny random model, for CPU smoke runs


def load_adapter_file(path: str, kind: str):
    """An adapter of `kind` ("unet_lora", "te_lora", "prefix") from a
    reference `.pth`/`.pt`/`.bin` file or the port's `.npz`."""
    if path.endswith((".pth", ".pt", ".bin")):
        got, tree = load_reference_adapters(path)
        if got != kind:
            raise ValueError(f"{path}: contains {got}, expected {kind}")
        return tree
    tree = load_adapters(path)
    return torch.tensor(tree["prefix"]) if kind == "prefix" else tree


def main(cfg: GenImagesConfig) -> list[Path]:
    if cfg.preset not in ("sd15", "sdxl"):
        raise ValueError(f"--preset {cfg.preset!r}: sd15 or sdxl")
    sd_cfg = SDConfig.preset({"sd15": "tiny", "sdxl": "tiny_xl"}[cfg.preset] if cfg.tiny_smoke else cfg.preset)
    sd = StableDiffusion(sd_cfg, device=cfg.device or None)
    if cfg.model_dir:
        t0 = time.perf_counter()
        sd.load_params(cfg.model_dir)
        print(f"[gen-images] loaded {cfg.model_dir} in {time.perf_counter() - t0:.1f} s", flush=True)
    else:
        sd.init_random(cfg.random_seed)
    tokenizer = load_tokenizer(cfg.tokenizer_dir or None)
    if cfg.tiny_smoke:
        tokenizer.vocab_size = sd_cfg.text.vocab_size
        tokenizer.bos_token_id = 0
        tokenizer.eos_token_id = sd_cfg.text.vocab_size - 1
        tokenizer.pad_token_id = sd_cfg.text.vocab_size - 1

    unet_lora, te_lora, prefix_table = (
        load_adapter_file(path, kind) if path else None
        for path, kind in ((cfg.load_unet_lora_from, "unet_lora"),
                           (cfg.load_text_encoder_lora_from, "te_lora"),
                           (cfg.load_prefix_embedding_from, "prefix"))
    )

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
            if not (prompt_dir / f"img_{j}.jpg").exists()  # resume
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
                out = prompt_dir / f"img_{j}.jpg"
                save_image(img, out)
                written.append(out)
        dt = time.perf_counter() - t0
        print(
            f"[gen-images] prompt {pi}: {len(todo)} imgs in {dt:.1f}s "
            f"({len(todo) / dt:.2f} img/s) -> {prompt_dir}"
        )
    return written


def parse_args(argv: list[str] | None = None) -> GenImagesConfig:
    """`--field value` for every field of GenImagesConfig, after `--config
    FILE` (a YAML file of such fields, e.g. configs/gen_tiny_cpu.yaml)."""
    return cfglib.cli_parse(GenImagesConfig, argv)


if __name__ == "__main__":
    main(parse_args())
