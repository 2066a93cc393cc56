"""fairdiff_torch exp-1 trainer against the JAX package's trainer.

- `chain_eps_cotangents` and the grad-mode sampler against JAX;
- the port's linearized phase 4 against its own chain backward (the
  counterpart of tests/test_trainer.py::test_linearized_phase4_matches_chain);
- (one full `train_step` against the JAX trainer is in
  test_torch_trainer_step.py for exp-1, test_torch_trainer_ot.py and
  test_torch_trainer_exps.py for the other experiments, all through
  `assert_steps_match_jax`);
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
from fairdiff.training import presets as jpresets
from fairdiff.training import synthetic as jsyn
from fairdiff.utils import rng as jrng
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


def _jax_setup(cfg=CFG, remat: bool = False):
    """The JAX trainer on the tiny SD (its UNet rematerialised per block
    with `remat`) and the synthetic stack for the config's attributes, and
    its initial state with seeded non-zero LoRA `up` leaves."""
    jsd = jpipe.StableDiffusion(jpipe.SDConfig.tiny(), remat=remat)
    params = random_tree(jax.eval_shape(jsd.init_params, jax.random.key(0)), seed=3)
    jstack = jsyn.synthetic_stack(cfg.get("attributes", ("gender",)))
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


def _port_trainer(params, jstack, cfg=CFG, remat: bool = False):
    tsd = tpipe.StableDiffusion(tpipe.SDConfig.tiny(), device="cpu", remat=remat).load_jax(params)
    tstack = tsyn.synthetic_stack(cfg.get("attributes", ("gender",)), db_feats=np.asarray(jstack.face_db.feats))
    return tdebias.DebiasTrainer(tsd, tstack, tdebias.DebiasConfig(**cfg))


def preset_cfg(name: str, **overrides) -> dict:
    """A JAX preset cut to these tests' tiny step: 4 lanes, micro-batch 2,
    2 denoising steps, LoRA rank 2."""
    cfg = dataclasses.asdict(jpresets.PRESETS[name]())
    cfg.update(lora_rank=2, train_images_per_prompt=4, train_micro_batch=2, steps_low=2, steps_high=2)
    cfg.update(overrides)
    return cfg


def assert_steps_match_jax(cfg: dict, n_train_steps: int = 1, remat: bool = False,
                           adam_slack: bool = False) -> list[dict]:
    """`n_train_steps` port `train_step`s against the JAX trainer's from the
    same weights, adapters, noises and step counts (linearized phase 4; with
    `remat`, both UNets rematerialised per block).
    Each step: targets exact; per leaf the grads within 2e-4 relative L2
    (fp32 through the tiny CLIP, UNet, VAE and the sampler, whose 1/alpha
    amplifies summation-order noise ~15x); the updated adapters and EMA
    within 1e-7 + 1e-6 relative (two fp32 ulps at |x| ~ 1, against a first
    AdamW step of ~lr = 5e-5 per element); every logged loss, norm and bias
    metric within 1e-4 relative. -> the port's targets of each step.

    `adam_slack` (one step only) lets each adapter and EMA element also
    differ by the change in AdamW's first update that the two sides'
    gradients explain, lr * |g_t / (|g_t| + eps) - g_j / (|g_j| + eps)|:
    where an element's gradient is near Adam's eps (1e-8), its fp32
    summation noise becomes a visible update. The tiny UNet LoRA has such
    elements (|g| ~ 1e-7 against a leaf maximum of 2.4e-2, where the JAX
    trainer's own remat and plain UNets differ by 2%)."""
    jtr, params, jstack, jstate = _jax_setup(cfg, remat)
    jtr.keep_pair_inputs = True
    ttr = _port_trainer(params, jstack, cfg, remat)
    tstate = ttr.init_state(adapters=adapters_from_jax(jstate.adapters))
    key = jax.random.key(42)
    ids = (jnp.asarray(COND), jnp.asarray(UNCOND))
    targets = []
    for step in range(n_train_steps):
        jstate, jlogs = jtr.train_step(jstate, ids, key)
        noises = np.asarray(jtr._last_pair_inputs["noises"])
        n_steps = jrng.sample_num_denoising_steps(key, step, cfg["steps_low"], cfg["steps_high"])
        tstate, tlogs = ttr.train_step(tstate, (COND, UNCOND), noises=noises, n_steps=n_steps)

        jt = {a: np.asarray(v) for a, v in jtr._last_pair_inputs["targets"].items()}
        assert set(ttr._last_targets) == set(jt) == set(ttr.cfg.attributes)
        for a, v in jt.items():
            np.testing.assert_array_equal(ttr._last_targets[a].numpy(), v)
        targets.append(jt)
        jg, tg = tree_leaves(jtr._last_grads), tree_leaves(ttr._last_grads)
        assert len(jg) == len(tg) > 0 and any(float(np.abs(g).max()) > 0 for g in jg)
        for j, t in zip(jg, tg):
            assert _rel(t.numpy(), j) < 2e-4
        assert not adam_slack or n_train_steps == 1
        norm = lambda g: np.asarray(g, np.float64) / (np.abs(np.asarray(g, np.float64)) + 1e-8)
        slack = [ttr.cfg.learning_rate * np.abs(norm(t.numpy()) - norm(j)) if adam_slack else 0.0
                 for j, t in zip(jg, tg)]
        for jtree, ttree in ((jstate.adapters, tstate.adapters), (jstate.ema, tstate.ema)):
            for j, t, sl in zip(tree_leaves(jtree), tree_leaves(ttree), slack):
                j, t = np.asarray(j), t.detach().numpy()
                assert t.shape == j.shape and np.all(np.abs(t - j) <= 1e-7 + 1e-6 * np.abs(j) + sl)
        assert tstate.step == jstate.step == step + 1
        assert set(tlogs) - {"grads_finite"} == set(jlogs)
        for k, v in jlogs.items():
            assert tlogs[k] == pytest.approx(v, rel=1e-4, abs=1e-7), k
    return targets


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(np.asarray(b)), 1e-30))


def _linear_vs_chain(cfg) -> set:
    """Grads of one port step by the linearized phase 4 and by the chain
    backward, leaf for leaf. -> the trained adapters' names."""
    jtr, params, jstack, jstate = _jax_setup(cfg)
    ttr = _port_trainer(params, jstack, cfg)
    noises = np.random.default_rng(9).normal(size=(4, 8, 8, 4)).astype(np.float32)
    grads = {}
    for mode in ("chain", "linear"):
        state = ttr.init_state(adapters=adapters_from_jax(jstate.adapters))
        _, logs = ttr.train_step(state, (COND, UNCOND), noises=noises, n_steps=2, phase4=mode)
        grads[mode] = (tree_leaves(ttr._last_grads), logs["train_loss"])
    (gc, lc), (gl, ll) = grads["chain"], grads["linear"]
    assert len(gc) == len(gl) == len(tree_leaves(jstate.adapters)) and any(float(g.abs().max()) > 0 for g in gc)
    for c, l in zip(gc, gl):
        np.testing.assert_allclose(l.numpy(), c.numpy(), rtol=5e-4, atol=5e-7)
    assert abs(lc - ll) < 1e-5
    return set(jstate.adapters)


def test_linearized_phase4_matches_chain():
    """The port's linearized phase 4 equals its own chain backward, with
    UNet and text-encoder LoRA trained: exact maths (the chain is affine in
    the guided epsilons), so only fp32 summation order differs (5e-4
    relative, as the JAX test)."""
    _linear_vs_chain(dict(CFG, train_unet=True))


def test_linearized_phase4_matches_chain_with_prefix():
    """The same with the soft prefix and the text-encoder LoRA trained
    together: one VJP of the context into both."""
    assert _linear_vs_chain(dict(CFG, train_prefix=True)) == {"prefix", "te_lora"}


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


def test_train_debias_cli_with_guidance_dir_on_cpu(tmp_path, capsys):
    """--guidance_dir loads the real-architecture stack (a seeded directory
    whose detector finds a face in every lane) and --flash_bwd merged
    selects K6's route; two tiny steps train the adapters."""
    from chip_smoke import seed_guidance_dir

    gdir = seed_guidance_dir(tmp_path / "guidance")
    cfg = train_debias.parse_args([
        "--device", "cpu", "--tiny_smoke", "1", "--max_train_steps", "2", "--guidance_dir", str(gdir),
        "--flash_bwd", "merged", "--output_dir", str(tmp_path / "out"),
    ])
    trainer = train_debias.build_trainer(cfg)
    assert trainer.guidance.face_embed_fn is not None and trainer.sd.unet.flash_bwd == "merged"
    state = train_debias.main(cfg)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["step"] for x in lines] == [1, 2] and state.step == 2
    for x in lines:
        assert x["face_rate"] == 1.0 and x["grads_finite"] and x["grad_norm"] > 0
    ups = []

    def collect(node):  # every LoRA `up` leaf: it starts at 0
        for k, v in node.items():
            collect(v) if isinstance(v, dict) else ups.append(v) if k == "up" else None

    collect(load_adapters(tmp_path / "out" / "exported" / "te_lora.npz"))
    assert ups and all(np.abs(a).max() > 0 for a in ups)
    with pytest.raises(ValueError, match="flash_bwd"):
        train_debias.build_trainer(dataclasses.replace(cfg, flash_bwd="both"))
