"""fairdiff_torch's trainer against the JAX trainer's for exp-6 (race only,
enumerated-multinomial OT, `target_kind="enum"`) and exp-2 (the soft
prefix instead of the text-encoder LoRA, here with a 2-step learning-rate
warm-up over two optimizer steps, so that lr 0 and lr/2 are both held),
each preset cut to the tiny step (4 lanes, micro-batch 2, 2 denoising
steps) on the synthetic stack; limits as `assert_steps_match_jax` states
them. Then the CLI on the CPU for exp-2 (the exported prefix table read
back by `gen_images`) and exp-5 (mixed prompt files).
"""

import json

import numpy as np
import torch

from fairdiff_torch.io.adapters_io import load_adapters
from fairdiff_torch.tools import gen_images, train_debias
from test_torch_trainer import COND, assert_steps_match_jax, preset_cfg

torch.set_num_threads(1)


def test_enumerated_ot_step_matches_jax_trainer():
    """Gate at 0.4, as in test_torch_trainer_ot.py: with 4 lanes the
    presets' 0.2 gates nearly every lane."""
    (targets,) = assert_steps_match_jax(preset_cfg("exp6", uncertainty_thresholds=(0.4,)))
    assert list(targets) == ["race"] and (targets["race"] != -1).any()


def test_prefix_steps_match_jax_trainer():
    """Two exp-2 steps: the prefix table is the only adapter; the prefixed
    cond ids (4 + 5 tokens) are longer than the raw uncond ids, which are
    padded to them; phase 3 runs the raw ids."""
    cfg = preset_cfg("exp2", lr_warmup_steps=2)
    assert not cfg["train_text_encoder"] and cfg["train_prefix"] and COND.shape[1] + 5 <= 16
    targets = assert_steps_match_jax(cfg, n_train_steps=2)
    assert len(targets) == 2 and all((t["gender"] != -1).any() for t in targets)


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


def test_train_debias_cli_exp2_exports_a_prefix_gen_images_reads(tmp_path, capsys):
    out = tmp_path / "out"
    cfg = train_debias.parse_args([
        "--device", "cpu", "--tiny_smoke", "1", "--experiment", "exp2", "--max_train_steps", "2",
        "--output_dir", str(out),
    ])
    trainer = train_debias.build_trainer(cfg)
    state0 = trainer.init_state(cfg.seed)
    init_rows = state0.adapters["prefix"].detach().numpy().copy()
    emb = trainer.sd.text_encoder.token_embedding.weight.detach().numpy()
    assert all((emb == row).all(axis=1).any() for row in init_rows)  # rows of the token table
    state = train_debias.main(cfg)
    lines = _lines(capsys)
    assert [x["step"] for x in lines] == [1, 2] and set(state.adapters) == {"prefix"}
    for x in lines:
        assert x["grads_finite"] and x["grad_norm"] > 0 and np.isfinite(x["train_loss"])
    saved = load_adapters(out / "exported" / "prefix.npz")
    assert list(saved) == ["prefix"] and saved["prefix"].shape == init_rows.shape
    assert not np.array_equal(saved["prefix"], init_rows)
    np.testing.assert_array_equal(saved["prefix"], state.adapters["prefix"].detach().numpy())
    assert list(load_adapters(out / "exported" / "prefix_EMA.npz")) == ["prefix"]

    imgs = {}
    for name, extra in (("with", ["--load_prefix_embedding_from", str(out / "exported" / "prefix.npz")]),
                        ("without", [])):
        gcfg = gen_images.parse_args([
            "--device", "cpu", "--tiny_smoke", "1", "--num_imgs_per_prompt", "1", "--batch_size", "1",
            "--num_denoising_steps", "2", "--save_dir", str(tmp_path / name), *extra,
        ])
        (path,) = gen_images.main(gcfg)
        imgs[name] = path.read_bytes()
    assert imgs["with"] != imgs["without"]


def test_train_debias_cli_exp5_mixes_prompt_files(tmp_path, capsys, monkeypatch):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps({"train_prompts": ["a photo of a doctor"]}))
    b.write_text(json.dumps({"train_prompts": ["a photo of a swimmer", "a photo of a chef"]}))
    seen = []
    tokenize = train_debias.tokenize_prompts
    monkeypatch.setattr(train_debias, "tokenize_prompts",
                        lambda sd, tok, prompts: seen.extend(prompts) or tokenize(sd, tok, prompts))
    cfg = train_debias.parse_args([
        "--device", "cpu", "--tiny_smoke", "1", "--experiment", "exp5", "--max_train_steps", "2",
        "--multi_prompts_json", f"{a},{b}", "--multi_prompts_repeats", "1,6", "--output_dir", str(tmp_path / "out"),
    ])
    state = train_debias.main(cfg)
    assert seen == ["a photo of a doctor"] + ["a photo of a swimmer", "a photo of a chef"] * 6
    lines = _lines(capsys)
    assert [x["step"] for x in lines] == [1, 2] and state.step == 2
    for x in lines:
        assert x["grads_finite"] and x["grad_norm"] > 0 and "race_gap" in x and "gender_race_gap" in x
    assert (tmp_path / "out" / "exported" / "te_lora.npz").exists()
