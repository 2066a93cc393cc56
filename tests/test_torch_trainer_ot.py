"""fairdiff_torch `train_step` against the JAX trainer's for the sampled-OT
experiments: exp-3's gender x race (`target_kind="ot2"`) and exp-4's gender
x race x age (`"ot3"`), each preset cut to the tiny step (4 lanes,
micro-batch 2, 2 denoising steps) on the synthetic stack for its
attributes, with the preset's 200 OT draws from the step's seeded numpy
generator. Limits as `assert_steps_match_jax` states them.

The gates stand at 0.4 here: with 4 lanes no OT target is surer than 0.11
and most sit above the presets' 0.2, which would gate every lane and leave
the fairness loss off; at 0.4 each attribute keeps some lanes and gates
others.
"""

import pytest
import torch

from test_torch_trainer import assert_steps_match_jax, preset_cfg

torch.set_num_threads(1)

GATE = 0.4


@pytest.mark.parametrize("preset", ["exp3", "exp4"])
def test_sampled_ot_step_matches_jax_trainer(preset):
    n_attrs = {"exp3": 2, "exp4": 3}[preset]
    (targets,) = assert_steps_match_jax(preset_cfg(preset, uncertainty_thresholds=(GATE,) * n_attrs))
    assert len(targets) == n_attrs
    assert all((t != -1).any() for t in targets.values())  # every attribute keeps a lane
    assert any((t == -1).any() for t in targets.values())  # and the gate removes some
