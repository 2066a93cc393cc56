"""One fairdiff_torch exp-1 `train_step` on a guidance stack read from
`convert_guidance`'s output, against one JAX `DebiasTrainer.train_step` on
the JAX stack read from the JAX converter's output of the same reference
files (tests/test_torch_convert_cli.py writes them): SCRFD from a
det_10g-shaped `.onnx` composed over FaceDetectorNet, MobileNetV3-Large,
CLIP-vision and DINOv2 at width 32, SFNet-20 and a face database. The
tiny SD, adapters, noises and step count as in
tests/test_torch_trainer_zoo.py, float32 on the CPU, with its tolerances
but for the gradients' and the first AdamW update's (below).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairdiff.sampling import pipeline as jpipe
from fairdiff.training import debias as jdebias
from fairdiff.training import model_zoo as jzoo
from fairdiff.utils import rng as jrng
from fairdiff_torch.io.from_jax import adapters_from_jax
from fairdiff_torch.sampling import pipeline as tpipe
from fairdiff_torch.training import debias as tdebias
from fairdiff_torch.training import model_zoo as tzoo
from fairdiff_torch.utils.tree import tree_leaves
from test_torch_convert_cli import convert_both, tiny_towers  # noqa: F401 (a fixture)
from test_torch_trainer import CFG, COND, UNCOND, _jax_setup, _rel

torch.set_num_threads(1)

# the chip and the stack's small resize at the tiny SD's 64 px; the aligned
# face stays at SFNet-20's 112
SIZES = dict(chip_size=32, img_size_small=64)
# SFNet-20 at its published width has no normalisation, and through 20 layers
# of random weights its VJP alone differs by 3.5e-4 relative L2 between the
# two frameworks on the same inputs (MobileNetV3's by 1.3e-6); the face loss
# carries that into every gradient (2e-4 to 7e-4 measured), so the grads are
# held to 1e-3 here, where tests/test_torch_trainer_zoo.py's tiny SFNet allows 2e-4
GRAD_REL_TOL = 1e-3


def test_train_step_on_converted_guidance_matches_jax_trainer(tmp_path, tiny_towers):  # noqa: F811
    tdir, jdir = convert_both(tmp_path, *tiny_towers)
    jstack = dataclasses.replace(jzoo.load_guidance_stack(jdir, ("gender",), dtype=jnp.float32), **SIZES)
    stack = dataclasses.replace(tzoo.load_guidance_stack(tdir, ("gender",), dtype=torch.float32, device="cpu"),
                                **SIZES)
    _, params, _, jstate = _jax_setup()
    jtr = jdebias.DebiasTrainer(jpipe.StableDiffusion(jpipe.SDConfig.tiny()), params, jstack,
                                jdebias.DebiasConfig(**CFG))
    jtr.keep_pair_inputs = True
    key = jax.random.key(42)
    jnew, jlogs = jtr.train_step(jstate, (jnp.asarray(COND), jnp.asarray(UNCOND)), key)
    noises = np.asarray(jtr._last_pair_inputs["noises"])
    n_steps = jrng.sample_num_denoising_steps(key, 0, 2, 2)

    tsd = tpipe.StableDiffusion(tpipe.SDConfig.tiny(), device="cpu").load_jax(params)
    ttr = tdebias.DebiasTrainer(tsd, stack, tdebias.DebiasConfig(**CFG))
    tstate = ttr.init_state(adapters=adapters_from_jax(jstate.adapters))
    tnew, tlogs = ttr.train_step(tstate, (COND, UNCOND), noises=noises, n_steps=n_steps)

    assert tlogs["face_rate"] == jlogs["face_rate"] == 1.0
    for a, v in jtr._last_pair_inputs["targets"].items():
        np.testing.assert_array_equal(ttr._last_targets[a].numpy(), np.asarray(v))
    jg, tg = tree_leaves(jtr._last_grads), tree_leaves(ttr._last_grads)
    assert len(jg) == len(tg) > 0 and any(float(np.abs(g).max()) > 0 for g in jg)
    for j, t in zip(jg, tg):
        assert _rel(t.numpy(), j) < GRAD_REL_TOL
    # AdamW's first update is ~lr * g / (|g| + eps): as in
    # tests/test_torch_trainer.py's `adam_slack`, each element may also differ
    # by what the two sides' gradients explain there
    norm = lambda g: np.asarray(g, np.float64) / (np.abs(np.asarray(g, np.float64)) + 1e-8)
    slack = [ttr.cfg.learning_rate * np.abs(norm(t.numpy()) - norm(j)) for j, t in zip(jg, tg)]
    for jtree, ttree in ((jnew.adapters, tnew.adapters), (jnew.ema, tnew.ema)):
        for j, t, sl in zip(tree_leaves(jtree), tree_leaves(ttree), slack):
            j, t = np.asarray(j), t.detach().numpy()
            assert t.shape == j.shape and np.all(np.abs(t - j) <= 1e-7 + 1e-6 * np.abs(j) + sl)
    for k in ("train_loss", "train_loss_fair", "train_loss_face", "train_loss_CLIP", "train_loss_DINO"):
        assert tlogs[k] == pytest.approx(jlogs[k], rel=1e-4, abs=1e-7), k
    assert tlogs["grad_norm"] == pytest.approx(jlogs["grad_norm"], rel=GRAD_REL_TOL)
