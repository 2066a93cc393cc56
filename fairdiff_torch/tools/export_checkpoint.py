"""Checkpoint -> standalone adapter files (counterpart of
fairdiff/tools/export_checkpoint.py, the reference's 2-export-checkpoint.py).

Restores a `train_debias` checkpoint and writes each adapter and its EMA as
`.npz` (`<name>.npz`, `<name>_EMA.npz`, which `gen_images` reads), and with
`--reference_format 1` also the reference's `.pth` files
(`text_encoder_lora[_EMA].pth`, `unet_lora[_EMA].pth`,
`prefix_embedding[_EMA].pth`). The restore template takes its adapter shapes
from the model built on the `meta` device, so no SD weights are made. Give
the run's `--experiment`, `--debias_config`, `--tiny_smoke` and `--sd_config`
so the template has the run's adapters.

  python -m fairdiff_torch.tools.export_checkpoint --tiny_smoke 1 \\
      --checkpoint_dir outputs/debias/checkpoints --reference_format 1
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from fairdiff_torch.models.clip_text import CLIPTextModel
from fairdiff_torch.models.unet2d import UNet2DCondition
from fairdiff_torch.tools import train_debias
from fairdiff_torch.training.checkpoints import DualCadenceCheckpointer
from fairdiff_torch.training.debias import DebiasState, init_adapters, new_state
from fairdiff_torch.utils import config as cfglib
from fairdiff_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ExportConfig:
    experiment: str = "exp1"
    debias_config: str = ""  # the run's YAML merged onto the preset
    sd_config: str = "sd15"
    tiny_smoke: bool = False
    checkpoint_dir: str = "outputs/debias/checkpoints"
    step: int = -1  # -1 = the latest
    output_dir: str = ""  # default <checkpoint_dir>/<step>_exported
    seed: int = 42
    reference_format: bool = False  # also the reference's .pth files


def restore_template(cfg: ExportConfig) -> DebiasState:
    """A CPU state of zeros shaped as the run's adapters."""
    tcfg = train_debias.TrainCLIConfig(
        experiment=cfg.experiment, debias_config=cfg.debias_config, sd_config=cfg.sd_config,
        tiny_smoke=cfg.tiny_smoke, seed=cfg.seed,
    )
    dcfg = train_debias.debias_config(tcfg)
    arch = train_debias.sd_config(tcfg)
    with torch.device("meta"):
        text_encoder, unet = CLIPTextModel(arch.text), UNet2DCondition(arch.unet)
    shapes = init_adapters(dcfg, text_encoder, unet, cfg.seed)
    return new_state(dcfg, tree_map(lambda x: torch.zeros(x.shape), shapes), torch.device("cpu"))


def main(cfg: ExportConfig) -> Path:
    ckpt = DualCadenceCheckpointer(cfg.checkpoint_dir)
    state = ckpt.restore(restore_template(cfg), None if cfg.step < 0 else cfg.step)
    out = Path(cfg.output_dir or f"{cfg.checkpoint_dir}/{state.step}_exported")
    train_debias.export_adapters(state, out, reference_format=cfg.reference_format)
    print(f"[export] step {state.step} adapters -> {out}")
    return out


if __name__ == "__main__":
    main(cfglib.cli_parse(ExportConfig))
