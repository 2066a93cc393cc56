"""Experiment presets (counterpart of fairdiff/training/presets.py). Only
exp-1 is ported; the other experiments need the OT targets and wait."""

from __future__ import annotations

import dataclasses

from fairdiff_torch.training.debias import DebiasConfig


def exp1(**overrides) -> DebiasConfig:
    """Gender debias via text-encoder LoRA
    (exp-1-debias-gender/configs/debias-text-encoder.yaml)."""
    cfg = DebiasConfig(
        attributes=("gender",),
        train_unet=False,
        weight_loss_img=8.0,
        weight_loss_face=1.0,
        factor1=(0.2,),
        factor2=(0.2,),
        uncertainty_thresholds=(0.2,),
        train_images_per_prompt=24,
        train_micro_batch=4,
        learning_rate=5e-5,
        max_train_steps=10000,
    )
    return dataclasses.replace(cfg, **overrides)


PRESETS = {"exp1": exp1}
