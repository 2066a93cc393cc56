"""fairdiff_torch's trainer config, experiment presets and exp-5 prompt
mixing against the JAX package's: field for field, and prompt for prompt on
JSON files written under `tmp_path`."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from fairdiff.io import prompts as jprompts
from fairdiff.training import debias as jdebias
from fairdiff.training import presets as jpresets
from fairdiff_torch.io import prompts as tprompts
from fairdiff_torch.training import debias as tdebias
from fairdiff_torch.training import presets as tpresets

torch.set_num_threads(1)


def test_debias_config_has_the_jax_fields():
    """The same names, defaults and order."""
    want = [(f.name, f.default) for f in dataclasses.fields(jdebias.DebiasConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(tdebias.DebiasConfig)]
    assert got == want


@pytest.mark.parametrize("name", ["exp1", "exp2", "exp3", "exp4", "exp5", "exp6"])
def test_preset_matches_jax(name):
    assert set(tpresets.PRESETS) == set(jpresets.PRESETS)
    assert dataclasses.asdict(tpresets.PRESETS[name]()) == dataclasses.asdict(jpresets.PRESETS[name]())
    over = {"seed": 7, "train_images_per_prompt": 8, "output_dir": "elsewhere"}
    assert dataclasses.asdict(tpresets.PRESETS[name](**over)) == dataclasses.asdict(jpresets.PRESETS[name](**over))


def _write(path, data):
    path.write_text(json.dumps(data))
    return str(path)


def test_multi_domain_prompts_match_jax(tmp_path):
    a = _write(tmp_path / "occupation.json", {
        "prompt_templates_train": ["a photo of a {occupation}", "a portrait of a {}"],
        "occupations_train_set": ["doctor", "nurse"],
        "prompt_templates_test": ["a photo of the face of a {occupation}"],
        "occupations_val_set": ["pilot"],
        "test_prompts": ["a chef"],
    })
    b = _write(tmp_path / "sports.json", {
        "train_prompts": ["a person playing tennis", "a swimmer"],
        "val_prompts": ["a runner"],
    })
    c = _write(tmp_path / "descriptor.json", {"train_prompts": ["a happy person"], "test_prompts": ["a tall person"]})
    for paths, repeats in (([a, b], [1, 6]), ([a, b, c], [1, 6, 20]), ([c, a], [4, 1])):
        got = tprompts.load_multi_domain_prompts(paths, repeats)
        assert got == jprompts.load_multi_domain_prompts(paths, repeats)
    got = tprompts.load_multi_domain_prompts([a, b], [1, 6])
    assert len(got["train_prompts"]) == 4 + 2 * 6 and got["val_prompts"] == ["a photo of the face of a pilot", "a runner"]


def test_ot_draws_and_the_warmup_schedule_match_jax():
    """`ot_draws` on one data shard, and the learning rate of each finite
    update against the JAX trainer's optax schedule, which computes it in
    fp32: within two fp32 ulps (2.4e-7 relative)."""
    import optax

    sd = types.SimpleNamespace(device=torch.device("cpu"))
    for over, draws in (({}, 200), ({"ot_num_samples": 0}, 100), ({"ot_num_samples": 0, "ot_samples_per_shard": 7}, 7)):
        assert tdebias.DebiasTrainer(sd, None, tpresets.exp3(**over)).ot_draws == draws
    for w in (0, 1, 3):
        cfg = tpresets.exp2(lr_warmup_steps=w)
        tr = tdebias.DebiasTrainer(sd, None, cfg)
        sched = optax.join_schedules(
            [optax.linear_schedule(0.0, cfg.learning_rate, max(w, 1)), optax.constant_schedule(cfg.learning_rate)],
            [max(w, 1)],
        ) if w else (lambda c: cfg.learning_rate)
        for count in range(6):
            np.testing.assert_allclose(tr.learning_rate(count), float(sched(count)), rtol=2.4e-7)
