"""fairdiff_torch exp-1 trainer against the JAX package's trainer.

- `chain_eps_cotangents` and the grad-mode sampler against JAX;
- the port's linearized phase 4 against its own chain backward (the
  counterpart of tests/test_trainer.py::test_linearized_phase4_matches_chain);
- (one full `train_step` against the JAX trainer is in
  test_torch_trainer_step.py);
- the CLI on the CPU.

Float32 on the CPU; each tolerance is stated where it is used.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairdiff.adapters import ema as jema
from fairdiff.sampling import dpm_solver as jdpm
from fairdiff.sampling import pipeline as jpipe
from fairdiff.training import debias as jdebias
from fairdiff.training import synthetic as jsyn
from fairdiff_torch.io.adapters_io import load_adapters
from fairdiff_torch.io.from_jax import adapters_from_jax
from fairdiff_torch.sampling import dpm_solver as tdpm
from fairdiff_torch.sampling import pipeline as tpipe
from fairdiff_torch.tools import train_debias
from fairdiff_torch.training import debias as tdebias
from fairdiff_torch.training import synthetic as tsyn
from fairdiff_torch.utils.tree import tree_leaves
from test_torch_models import random_tree

torch.set_num_threads(1)

CFG = dict(train_text_encoder=True, train_unet=False, lora_rank=2, train_images_per_prompt=4,
           train_micro_batch=2, steps_low=2, steps_high=2)
COND = np.array([[0, 5, 6, 63]], np.int32)
UNCOND = np.array([[0, 63, 1, 1]], np.int32)


@pytest.mark.parametrize("steps", [2, 19, 23])
def test_chain_eps_cotangents_match_jax(steps):
    """gamma_t * grad_coef_t by autograd over the scalar replay, against the
    JAX scan replay: the same fp32 recurrence, 1e-5 relative."""
    cfg = jdpm.DPMSolverConfig()
    jb = jdpm.make_step_bundle(cfg, jdpm.make_schedule(cfg), steps)
    tb = tdpm.make_step_bundle(tdpm.DPMSolverConfig(), tdpm.make_schedule(tdpm.DPMSolverConfig()), steps)
    want = np.asarray(jdpm.chain_eps_cotangents(jb))
    got = tdpm.chain_eps_cotangents(tb)
    assert got.shape == (steps,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_grad_mode_denoise_matches_jax():
    """The grad-mode chain (detached UNet input, rescaled epsilon cotangent)
    and its trajectory against the JAX scan: values and the gradient of a
    weighted sum of the final latents with respect to a parameter of the
    epsilon function (1e-5 relative)."""
    cfg = jdpm.DPMSolverConfig()
    jb = jdpm.make_step_bundle(cfg, jdpm.make_schedule(cfg), 5)
    tb = tdpm.make_step_bundle(tdpm.DPMSolverConfig(), tdpm.make_schedule(tdpm.DPMSolverConfig()), 5)
    rng = np.random.default_rng(3)
    lat = rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
    w = rng.normal(size=(2, 4, 4, 4)).astype(np.float32)

    def jrun(theta):
        eps = lambda x2, t: theta * x2 + jnp.concatenate([jnp.zeros_like(x2[:2]), 0.01 * x2[2:] ** 2]) + t / 1000.0
        final, traj = jdpm.denoise(eps, jnp.asarray(lat), jb, grad_mode=True, return_trajectory=True)
        return jnp.sum(final * w), (final, traj)

    (_, (jfinal, jtraj)), jg = jax.value_and_grad(jrun, has_aux=True)(jnp.float32(0.3))
    theta = torch.tensor(0.3, requires_grad=True)
    eps = lambda x2, t: theta * x2 + torch.cat([torch.zeros_like(x2[:2]), 0.01 * x2[2:] ** 2]) + t / 1000.0
    final, traj = tdpm.denoise(eps, torch.from_numpy(lat), tb, grad_mode=True, return_trajectory=True)
    (final * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(final.detach().numpy(), np.asarray(jfinal), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(theta.grad.item(), float(jg), rtol=1e-5)


def _jax_setup(cfg=CFG):
    jsd = jpipe.StableDiffusion(jpipe.SDConfig.tiny())
    params = random_tree(jax.eval_shape(jsd.init_params, jax.random.key(0)), seed=3)
    jstack = jsyn.synthetic_stack(("gender",))
    jtr = jdebias.DebiasTrainer(jsd, params, jstack, jdebias.DebiasConfig(**cfg))
    state = jtr.init_state(jax.random.key(1))
    rng = np.random.default_rng(8)
    # non-zero `up` so the first step's grads reach `down` too
    adapters = jax.tree_util.tree_map_with_path(
        lambda path, x: (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        if path[-1].key == "up" else np.asarray(x), state.adapters,
    )
    state = jdebias.DebiasState(adapters, jtr.tx.init(adapters), jema.init_ema(adapters), 0)
    return jtr, params, jstack, state


def _port_trainer(params, jstack, cfg=CFG):
    tsd = tpipe.StableDiffusion(tpipe.SDConfig.tiny(), device="cpu").load_jax(params)
    tstack = tsyn.synthetic_stack(("gender",), db_feats=np.asarray(jstack.face_db.feats))
    port_cfg = {k: v for k, v in cfg.items() if k != "train_text_encoder"}  # the port always trains it
    return tdebias.DebiasTrainer(tsd, tstack, tdebias.DebiasConfig(**port_cfg))


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(np.asarray(b)), 1e-30))


def test_linearized_phase4_matches_chain():
    """The port's linearized phase 4 equals its own chain backward, with
    UNet and text-encoder LoRA trained: exact maths (the chain is affine in
    the guided epsilons), so only fp32 summation order differs (5e-4
    relative, as the JAX test)."""
    cfg = dict(CFG, train_unet=True)
    jtr, params, jstack, jstate = _jax_setup(cfg)
    ttr = _port_trainer(params, jstack, cfg)
    noises = np.random.default_rng(9).normal(size=(4, 8, 8, 4)).astype(np.float32)
    grads = {}
    for mode in ("chain", "linear"):
        state = ttr.init_state(adapters=adapters_from_jax(jstate.adapters))
        _, logs = ttr.train_step(state, (COND, UNCOND), noises=noises, n_steps=2, phase4=mode)
        grads[mode] = (tree_leaves(ttr._last_grads), logs["train_loss"])
    (gc, lc), (gl, ll) = grads["chain"], grads["linear"]
    assert len(gc) == len(gl) and any(float(g.abs().max()) > 0 for g in gc)
    for c, l in zip(gc, gl):
        np.testing.assert_allclose(l.numpy(), c.numpy(), rtol=5e-4, atol=5e-7)
    assert abs(lc - ll) < 1e-5


def test_train_debias_cli_on_cpu(tmp_path, capsys, monkeypatch):
    cfg = train_debias.parse_args([
        "--device", "cpu", "--tiny_smoke", "1", "--max_train_steps", "2", "--output_dir", str(tmp_path),
    ])
    state = train_debias.main(cfg)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["step"] for x in lines] == [1, 2] and state.step == 2
    for x in lines:
        assert np.isfinite(x["train_loss"]) and x["grads_finite"] and x["grad_norm"] > 0
        assert x["face_rate"] == 1.0 and x["num_denoising_steps"] == 2
    saved = load_adapters(tmp_path / "exported" / "te_lora.npz")
    for a, b in zip(tree_leaves(saved), tree_leaves(state.adapters["te_lora"])):
        np.testing.assert_array_equal(a, b.detach().numpy())
    assert (tmp_path / "exported" / "te_lora_EMA.npz").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_debias.main(dataclasses.replace(cfg, device=""))
