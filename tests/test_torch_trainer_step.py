"""One fairdiff_torch exp-1 `train_step` against one JAX
`DebiasTrainer.train_step` at `SDConfig.tiny()` with the synthetic guidance
stack: the same weights (`load_jax`), adapters (the JAX `init_state` LoRA
with seeded non-zero `up`), noises and step count. Float32 on the CPU. Most
of this file's time is the JAX trainer's compilation of its five programs.
"""

import torch

from test_torch_trainer import CFG, assert_steps_match_jax

torch.set_num_threads(1)


def test_train_step_matches_jax_trainer():
    """One exp-1 step (4 lanes, micro-batch 2, 2 denoising steps, linearized
    phase 4) on both sides, held to `assert_steps_match_jax`'s limits."""
    assert_steps_match_jax(CFG)
