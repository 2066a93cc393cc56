"""`DebiasTrainer.evaluate` and `fit` of fairdiff_torch against the JAX
trainer's: the same tiny SD weights, synthetic stack, adapters and eval
noises give equal predictions, probabilities within 1e-4 and metric values
within 1e-4 (fp32 through the tiny sampler and the stack, as the step
tests' logged metrics); then the evaluation's files and keys as the JAX
package's `test_evaluate_artifacts_and_per_prompt_metrics` and
`test_fit_and_eval` pin them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairdiff.utils import rng as jrng
from fairdiff_torch.io.from_jax import adapters_from_jax
from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion
from fairdiff_torch.training.debias import DebiasConfig, DebiasTrainer
from fairdiff_torch.training.synthetic import synthetic_stack
from test_torch_trainer import COND, UNCOND, _jax_setup, _port_trainer, preset_cfg

torch.set_num_threads(1)

OTHER = np.array([[0, 9, 12, 63]], np.int32)  # a second validation prompt


def _capture(make_fn, sink: list):
    """Wrap a trainer's sample-and-analyse factory so each call's analysis
    lands in `sink`."""
    def factory(*a, **kw):
        fn = make_fn(*a, **kw)

        def call(*args):
            out = fn(*args)
            sink.append(out[1])
            return out
        return call
    return factory


def test_evaluate_matches_jax():
    cfg = preset_cfg("exp3", val_images_per_prompt=2, eval_denoising_steps=2)
    jtr, params, jstack, jstate = _jax_setup(cfg)
    ttr = _port_trainer(params, jstack, cfg)
    adapters = ttr.init_state(adapters=adapters_from_jax(jstate.adapters)).adapters
    root = jax.random.key(3)
    prompts = [(COND, UNCOND), (OTHER, UNCOND)]
    texts = ["a photo of a doctor", "a photo of a nurse"]
    noises = [np.asarray(jax.random.normal(jrng.noise_key(root, 10_000_000 + i), jtr.sd.latent_shape(2)))
              for i in range(len(prompts))]
    jres, tres = [], []
    jtr._sample_analyze_fn = _capture(jtr._sample_analyze_fn, jres)
    real = ttr._sample_analyze
    ttr._sample_analyze = lambda *a: (lambda out: (tres.append(out[1]), out)[1])(real(*a))
    want = jtr.evaluate(jstate.adapters, [(jnp.asarray(c), jnp.asarray(u)) for c, u in prompts], root,
                        name="main", step=2, prompt_texts=texts)
    got = ttr.evaluate(adapters, prompts, name="main", step=2, prompt_texts=texts, noises=noises)
    assert len(jres) == len(tres) == 2
    for j, t in zip(jres, tres):
        for a in cfg["attributes"]:
            np.testing.assert_array_equal(t.attrs[a].preds.numpy(), np.asarray(j.attrs[a].preds))
            np.testing.assert_allclose(t.attrs[a].probs.numpy(), np.asarray(j.attrs[a].probs), atol=1e-4)
    assert set(got) == set(want) and "race_gap_a_photo_of_a_nurse" in got
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-4, nan_ok=True), k


def _trainer(**overrides) -> DebiasTrainer:
    sd = StableDiffusion(SDConfig.tiny(), device="cpu").init_random(0)
    cfg = DebiasConfig(lora_rank=2, train_images_per_prompt=4, train_micro_batch=2, steps_low=2, steps_high=2,
                       val_images_per_prompt=2, eval_denoising_steps=2, max_train_steps=2, **overrides)
    return DebiasTrainer(sd, synthetic_stack(("gender",), device="cpu"), cfg)


def test_evaluate_artifacts_and_per_prompt_metrics(tmp_path):
    """Per-prompt keys, the generated and frozen-model grids, no frozen grid
    on the EMA pass, the cached frozen grid copied byte for byte at a later
    evaluation without another generation, and the label collision rule."""
    trainer = _trainer()
    state = trainer.init_state(1)
    ids = (torch.as_tensor(COND), torch.as_tensor(UNCOND))
    ev = trainer.evaluate(state.adapters, [ids], name="main", step=40, prompt_texts=["a photo of a doctor"],
                          grids_dir=tmp_path)
    label = "a_photo_of_a_doctor"
    assert "gender_gap" in ev and f"gender_gap_{label}" in ev
    assert (tmp_path / f"eval_main_40_{label}_generated.jpg").exists()
    assert (tmp_path / f"eval_main_40_{label}_ori.jpg").exists()
    trainer.evaluate(state.ema, [ids], name="ema", step=40, grids_dir=tmp_path, ori_grids=False)
    assert (tmp_path / "eval_ema_40_prompt0_generated.jpg").exists()
    assert not (tmp_path / "eval_ema_40_prompt0_ori.jpg").exists()
    calls = []
    real = trainer._sample_analyze
    trainer._sample_analyze = lambda *a: (calls.append(a[0]), real(*a))[1]
    trainer.evaluate(state.adapters, [ids], name="main", step=80, prompt_texts=["a photo of a doctor"],
                     grids_dir=tmp_path)
    assert len(calls) == 1 and calls[0] is state.adapters  # the frozen model did not run again
    ori40, ori80 = (tmp_path / f"eval_main_{s}_{label}_ori.jpg" for s in (40, 80))
    assert ori80.read_bytes() == ori40.read_bytes()
    ev3 = trainer.evaluate(state.adapters, [ids, ids], name="main", step=120, prompt_texts=["a b", "a/b"])
    assert "gender_gap_a_b" in ev3 and "gender_gap_a_b_p1" in ev3


def test_fit_logs_eval_and_ema_eval(tmp_path):
    trainer = _trainer(eval_interval=1, output_dir=str(tmp_path))
    records = []
    trainer.logger = lambda step, logs: records.append((step, logs))
    ids = (torch.as_tensor(COND), torch.as_tensor(UNCOND))
    state = trainer.fit(trainer.init_state(1), [ids], val_prompt_ids=[ids], val_prompt_texts=["doc"])
    assert state.step == 2
    for step in (1, 2):
        keys = set(k for s, logs in records if s == step for k in logs)
        assert {"eval_gender_gap", "eval_ema_gender_gap", "eval_gender_gap_doc", "step_time_s",
                "time_phase4_pair_vjp_s"} <= keys
    assert sorted(p.name for p in (tmp_path / "imgs").glob("*_ori.jpg")) == [
        "eval_main_1_doc_ori.jpg", "eval_main_2_doc_ori.jpg"]
