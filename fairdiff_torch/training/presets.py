"""Experiment presets (a copy of fairdiff/training/presets.py): the values
of the reference's exp-*/configs/debias-*.yaml, with the effective 2-GPU
global batches (train_images_per_prompt_GPU x 2)."""

from __future__ import annotations

import dataclasses

from fairdiff_torch.training.debias import DebiasConfig


def exp1(**overrides) -> DebiasConfig:
    """Gender debias via text-encoder LoRA
    (exp-1-debias-gender/configs/debias-text-encoder.yaml)."""
    cfg = DebiasConfig(
        attributes=("gender",),
        target_kind="binary",
        train_text_encoder=True,
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
        no_face_img_weight_one=True,
        face_search_all_lanes=False,
        # the reference's val_images_per_prompt_GPU: 16 x 2 GPUs
        val_images_per_prompt=32,
    )
    return dataclasses.replace(cfg, **overrides)


def exp2(**overrides) -> DebiasConfig:
    """Gender debias via soft prompt prefix (exp-2 configs/debias-token.yaml)."""
    cfg = exp1(
        train_text_encoder=False,
        train_prefix=True,
        num_prefix_tokens=5,
    )
    return dataclasses.replace(cfg, **overrides)


def exp3(**overrides) -> DebiasConfig:
    """Gender x race via sampled OT (exp-3 configs/debias-text-encoder.yaml)."""
    cfg = DebiasConfig(
        attributes=("gender", "race"),
        target_kind="ot2",
        train_text_encoder=True,
        weight_loss_img=8.0,
        weight_loss_face=0.1,
        factor1=(0.2, 0.6),
        factor2=(0.2, 0.3),
        uncertainty_thresholds=(0.2, 0.2),
        train_images_per_prompt=32,
        train_micro_batch=4,
        learning_rate=5e-5,
        max_train_steps=15000,
        no_face_img_weight_one=False,
        face_search_all_lanes=True,
        # the reference's 2-GPU total: 100 draws a device x 2 devices = 200
        # transport plans a step, pinned as a total so that one card gives
        # the reference's target sharpness
        ot_num_samples=200,
    )
    return dataclasses.replace(cfg, **overrides)


def exp4(**overrides) -> DebiasConfig:
    """Gender x race x age (75/25) (exp-4 configs)."""
    cfg = exp3(
        attributes=("gender", "race", "age"),
        target_kind="ot3",
        factor1=(0.2, 0.6, 0.6),
        factor2=(0.2, 0.3, 0.3),
        uncertainty_thresholds=(0.2, 0.2, 0.2),
        train_images_per_prompt=40,
    )
    return dataclasses.replace(cfg, **overrides)


def exp5(**overrides) -> DebiasConfig:
    """exp-3 objective over mixed prompt domains (exp-5 configs); the
    domain mixing is in prompt loading (`io.prompts.load_multi_domain_prompts`,
    repeats x1/x6/x20/x4)."""
    cfg = exp3(train_images_per_prompt=40)
    return dataclasses.replace(cfg, **overrides)


def exp6(**overrides) -> DebiasConfig:
    """Race-only enumerated-multinomial OT (exp-6 configs/debias-text-encoder.yaml)."""
    cfg = DebiasConfig(
        attributes=("race",),
        target_kind="enum",
        train_text_encoder=True,
        weight_loss_img=6.0,
        weight_loss_face=0.1,
        factor1=(0.6,),
        factor2=(0.3,),
        uncertainty_thresholds=(0.2,),
        train_images_per_prompt=32,
        train_micro_batch=4,
        learning_rate=5e-5,
        max_train_steps=12000,
        no_face_img_weight_one=False,
        face_search_all_lanes=True,
    )
    return dataclasses.replace(cfg, **overrides)


PRESETS = {
    "exp1": exp1, "exp2": exp2, "exp3": exp3,
    "exp4": exp4, "exp5": exp5, "exp6": exp6,
}
