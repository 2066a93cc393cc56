"""One fairdiff_torch exp-1 `train_step` against one JAX
`DebiasTrainer.train_step` at `SDConfig.tiny()` with the synthetic guidance
stack: the same weights (`load_jax`), adapters (the JAX `init_state` LoRA
with seeded non-zero `up`), noises and step count. Float32 on the CPU. Most
of this file's time is the JAX trainer's compilation of its five programs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairdiff.utils import rng as jrng
from fairdiff_torch.io.from_jax import adapters_from_jax
from fairdiff_torch.utils.tree import tree_leaves
from test_torch_trainer import COND, UNCOND, _jax_setup, _port_trainer, _rel

torch.set_num_threads(1)


def test_train_step_matches_jax_trainer():
    """One exp-1 step (4 lanes, micro-batch 2, 2 denoising steps, linearized
    phase 4) on both sides. Targets exact; per leaf the grads within 2e-4
    relative L2 (fp32 through the tiny CLIP, UNet, VAE and the sampler, whose
    1/alpha amplifies summation-order noise ~15x); the updated adapters and
    EMA within 1e-7 + 1e-6 relative (two fp32 ulps at |x| ~ 1, against a
    first AdamW step of ~lr = 5e-5 per element); the logged losses within
    1e-4 relative."""
    jtr, params, jstack, jstate = _jax_setup()
    jtr.keep_pair_inputs = True
    key = jax.random.key(42)
    jnew, jlogs = jtr.train_step(jstate, (jnp.asarray(COND), jnp.asarray(UNCOND)), key)
    noises = np.asarray(jtr._last_pair_inputs["noises"])
    n_steps = jrng.sample_num_denoising_steps(key, 0, 2, 2)

    ttr = _port_trainer(params, jstack)
    tstate = ttr.init_state(adapters=adapters_from_jax(jstate.adapters))
    tnew, tlogs = ttr.train_step(tstate, (COND, UNCOND), noises=noises, n_steps=n_steps)

    for a, v in jtr._last_pair_inputs["targets"].items():
        np.testing.assert_array_equal(ttr._last_targets[a].numpy(), np.asarray(v))
    jg, tg = tree_leaves(jtr._last_grads), tree_leaves(ttr._last_grads)
    assert len(jg) == len(tg) > 0 and any(float(np.abs(g).max()) > 0 for g in jg)
    for j, t in zip(jg, tg):
        assert _rel(t.numpy(), j) < 2e-4
    for jtree, ttree in ((jnew.adapters, tnew.adapters), (jnew.ema, tnew.ema)):
        for j, t in zip(tree_leaves(jtree), tree_leaves(ttree)):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-7, rtol=1e-6)
    assert tnew.step == jnew.step == 1
    for k in ("train_loss", "train_loss_fair", "train_loss_face", "train_loss_CLIP", "grad_norm", "face_rate"):
        assert tlogs[k] == pytest.approx(jlogs[k], rel=1e-4, abs=1e-7), k
    assert tlogs["num_denoising_steps"] == jlogs["num_denoising_steps"] == 2
