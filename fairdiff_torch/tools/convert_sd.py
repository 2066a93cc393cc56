"""Convert a diffusers-layout Stable Diffusion checkpoint directory into the
port's converted-parameter store (counterpart of
fairdiff/tools/convert_sd.py).

Input: a local `runwayml/stable-diffusion-v1-5`-style directory with
{text_encoder,unet,vae}/ subfolders holding `.safetensors` or torch
`.bin`/`.pth` weights (the layout `from_pretrained` reads). Output:
`<out_dir>/{text_encoder,unet,vae}.pt`, which `gen_images --model_dir` and
`train_debias --model_dir` read.

  python -m fairdiff_torch.tools.convert_sd --sd_dir /path/sd15 --out_dir /path/converted
  python -m fairdiff_torch.tools.convert_sd --sd_dir DIR --out_dir OUT --preset tiny
"""

from __future__ import annotations

import dataclasses
import time
import zipfile
from pathlib import Path

import torch

from fairdiff_torch.io import safetensors
from fairdiff_torch.io.checkpoints import save_params
from fairdiff_torch.io.sd_loader import convert_unet, convert_vae
from fairdiff_torch.io.torch_convert import convert_clip_text
from fairdiff_torch.sampling.pipeline import SDConfig
from fairdiff_torch.utils import config as cfglib


@dataclasses.dataclass(frozen=True)
class ConvertConfig:
    sd_dir: str = ""
    out_dir: str = "converted-sd15"
    # the architecture the checkpoint holds: "sd15", or "tiny" (the tests'
    # miniature in the same diffusers layout)
    preset: str = "sd15"


def load_state_dict(model_dir: Path) -> dict[str, torch.Tensor]:
    """Every tensor of a model subfolder: its `.safetensors` files, else its
    torch `.bin`/`.pth` files (sorted; a later file's key wins)."""
    out: dict[str, torch.Tensor] = {}
    sts = sorted(model_dir.glob("*.safetensors"))
    if sts:
        for f in sts:
            out.update(safetensors.load_file(f))
        return out
    bins = sorted(model_dir.glob("*.bin")) + sorted(model_dir.glob("*.pth"))
    if not bins:
        raise FileNotFoundError(f"no weights in {model_dir}")
    for f in bins:
        # the zip format (torch >= 1.6) maps; a legacy pickle is read whole
        out.update(torch.load(f, map_location="cpu", weights_only=True, mmap=zipfile.is_zipfile(f)))
    return out


def main(cfg: ConvertConfig) -> Path:
    arch = {"sd15": SDConfig.sd15, "tiny": SDConfig.tiny}[cfg.preset]()
    sd_dir, out = Path(cfg.sd_dir), Path(cfg.out_dir)
    converters = {
        "text_encoder": lambda sd: convert_clip_text(sd, arch.text.num_hidden_layers),
        "unet": lambda sd: convert_unet(sd, arch.unet),
        "vae": lambda sd: convert_vae(sd, arch.vae),
    }
    t0 = time.perf_counter()
    for name, convert in converters.items():  # one model in memory at a time
        save_params(out, {name: convert(load_state_dict(sd_dir / name))})
    print(f"[convert-sd] wrote {out} ({cfg.preset}) in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


if __name__ == "__main__":
    main(cfglib.cli_parse(ConvertConfig))
