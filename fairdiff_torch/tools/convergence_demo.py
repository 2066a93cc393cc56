"""Bias-convergence demo on the synthetic stack, no model assets needed
(counterpart of fairdiff/tools/convergence_demo.py).

The whole 4-phase loop (sample -> detect/classify -> dynamic targets ->
linearized differentiable-sampling backward -> AdamW + EMA) on the tiny SD
and the synthetic stack, driving |gender_gap| from its degenerate start
toward the 0.5/0.5 target (exp1), or the OT modes' gaps (exp3: gender x
race sampled OT; exp4: gender x race x age; exp6: race-only enumerated
OT). A sign error anywhere in the gradient chain shows as a flat or rising
curve. The steps are logged to `<output_dir>/metrics.jsonl` and rendered
by `tools/plot_curves` afterwards.

  python -m fairdiff_torch.tools.convergence_demo --steps 120 \\
      --output_dir outputs/convergence [--device cpu]

The tiny SD's weights come from `--seed` (`init_random`), the adapters from
seed 1 and the step's draws from `utils.rng`, so the curves are not the
JAX demo's numbers; `build` and `run` take the JAX demo's weights, adapters,
face database and draws where a caller passes them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from fairdiff_torch.utils import config as cfglib


@dataclass
class DemoConfig:
    # "exp1": rank/binomial gender targets; "exp3": gender x race sampled-OT
    # joint targets; "exp4": gender x race x age with the asymmetric age
    # target; "exp6": race-only enumerated-multinomial OT
    experiment: str = "exp1"
    steps: int = 120
    learning_rate: float = 2e-3  # tiny models need a larger lr to move
    # 0 = auto: 8 lanes for exp1, 16 for exp3/exp6, 24 for exp4 (the OT
    # modes need lanes over their joint classes for targets to clear the gate)
    train_images_per_prompt: int = 0
    train_micro_batch: int = 4
    ot_num_samples: int = 50  # the OT demos' draws a step (the presets: 200)
    seed: int = 0
    output_dir: str = "outputs/convergence"
    device: str = ""  # "" = cuda; "cpu" only when asked for
    plot: bool = True


# one fixed prompt, as in the trainer tests
COND = [[0, 5, 6, 63]]
UNCOND = [[0, 63, 1, 1]]


def demo_config(cfg: DemoConfig):
    """-> (DebiasConfig, the gap key printed) of the demo's mode: the JAX
    demo's fields."""
    from fairdiff_torch.training.debias import DebiasConfig

    lanes = cfg.train_images_per_prompt or {"exp3": 16, "exp6": 16, "exp4": 24}.get(cfg.experiment, 8)
    common = dict(
        train_text_encoder=True, lora_rank=2, learning_rate=cfg.learning_rate,
        train_images_per_prompt=lanes, train_micro_batch=cfg.train_micro_batch, steps_low=2, steps_high=2,
        eval_interval=0, max_train_steps=cfg.steps, output_dir=cfg.output_dir, seed=cfg.seed,
    )
    ot = dict(no_face_img_weight_one=False, face_search_all_lanes=True, weight_loss_img=8.0,
              weight_loss_face=0.1)
    if cfg.experiment == "exp3":
        return DebiasConfig(attributes=("gender", "race"), target_kind="ot2", factor1=(0.2, 0.6),
                            factor2=(0.2, 0.3), uncertainty_thresholds=(0.2, 0.2),
                            ot_num_samples=cfg.ot_num_samples, **ot, **common), "gender_race_gap"
    if cfg.experiment == "exp4":
        return DebiasConfig(attributes=("gender", "race", "age"), target_kind="ot3", factor1=(0.2, 0.6, 0.6),
                            factor2=(0.2, 0.3, 0.3), uncertainty_thresholds=(0.2, 0.2, 0.2),
                            ot_num_samples=cfg.ot_num_samples, **ot, **common), "age_gap"
    if cfg.experiment == "exp6":
        return DebiasConfig(attributes=("race",), target_kind="enum", factor1=(0.6,), factor2=(0.3,),
                            uncertainty_thresholds=(0.2,), **dict(ot, weight_loss_img=6.0), **common), "race_gap"
    if cfg.experiment == "exp1":
        return DebiasConfig(**common), "gender_gap_abs"
    # a typo must not silently produce an exp1 run labelled as another
    raise SystemExit(f"unknown --experiment {cfg.experiment!r} (choose exp1, exp3, exp4, exp6)")


def build(cfg: DemoConfig, params=None, adapters=None, db_feats=None):
    """-> (trainer, state, gap key): the tiny SD on `params` (the JAX demo's
    tree) or seeded weights, the synthetic stack (on the JAX demo's
    face-database rows `db_feats` where given), adapters from `adapters`
    or seed 1."""
    from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion
    from fairdiff_torch.training.debias import DebiasTrainer
    from fairdiff_torch.training.synthetic import synthetic_stack

    dcfg, gap_key = demo_config(cfg)
    sd = StableDiffusion(SDConfig.tiny(), device=cfg.device or None)
    sd = sd.load_jax(params) if params is not None else sd.init_random(cfg.seed)
    trainer = DebiasTrainer(sd, synthetic_stack(dcfg.attributes, db_feats=db_feats, device=sd.device), dcfg)
    return trainer, trainer.init_state(1, adapters), gap_key


def run(cfg: DemoConfig, trainer, state, gap_key: str,
        draws: Optional[Callable[[int], tuple[np.ndarray, int]]] = None):
    """`cfg.steps` steps from `state`, each logged; `draws(step)` gives a
    step's (noises, denoising steps) instead of `utils.rng`'s."""
    from fairdiff_torch.training.logging import MetricsLogger

    logger = MetricsLogger(cfg.output_dir)
    for step in range(cfg.steps):
        noises, n_steps = draws(state.step) if draws else (None, None)
        state, logs = trainer.train_step(state, (np.array(COND), np.array(UNCOND)), noises=noises, n_steps=n_steps)
        logger(step, logs)
        if step % 10 == 0 or step == cfg.steps - 1:
            print(f"[convergence] step {step}: {gap_key}={logs[gap_key]:.3f} "
                  f"loss_fair={logs.get('train_loss_fair', float('nan')):.4f}", flush=True)
    logger.close()
    return state


def main(cfg: DemoConfig):
    trainer, state, gap_key = build(cfg)
    state = run(cfg, trainer, state, gap_key)
    if cfg.plot:
        from fairdiff_torch.tools.plot_curves import PlotConfig
        from fairdiff_torch.tools.plot_curves import main as plot_main

        plot_main(PlotConfig(runs=f"synthetic={cfg.output_dir}/metrics.jsonl", save_dir=f"{cfg.output_dir}/curves"))
    return state


if __name__ == "__main__":
    main(cfglib.cli_parse(DemoConfig))
