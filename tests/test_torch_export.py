"""The reference's `.pth` adapter layouts (fairdiff_torch.io.reference_adapters
against fairdiff.io.reference_adapters on the same trees: same keys, equal
arrays), then the run's lifecycle through the CLIs on the CPU at the tiny
size: `train_debias` with `--debias_config` and `--resume_from_checkpoint`,
`export_checkpoint` (.npz and .pth) and `gen_images` reading the `.pth`
files. Exact comparisons."""

import json

import jax
import numpy as np
import pytest
import torch

from fairdiff.adapters import lora as jlora
from fairdiff.io import reference_adapters as jra
from fairdiff.sampling import pipeline as jpipe
from fairdiff_torch.io import reference_adapters as tra
from fairdiff_torch.io.adapters_io import load_adapters
from fairdiff_torch.tools import export_checkpoint, gen_images, train_debias
from fairdiff_torch.utils.tree import tree_leaves
from test_torch_models import random_tree

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trees():
    """A te_lora and a unet_lora tree on the tiny SD (every leaf drawn), and
    a prefix table, as numpy."""
    jsd = jpipe.StableDiffusion(jpipe.SDConfig.tiny())
    params = random_tree(jax.eval_shape(jsd.init_params, jax.random.key(0)), seed=1)
    rng = np.random.default_rng(4)
    draw = lambda t: jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), t)
    return {
        "te_lora": draw(jlora.init_lora(params["text_encoder"], jlora.text_encoder_targets, 2, jax.random.key(1))),
        "unet_lora": draw(jlora.init_lora(params["unet"], jlora.unet_attention_targets, 2, jax.random.key(2))),
        "prefix": rng.normal(size=(6, 32)).astype(np.float32),
    }


def _jax_save(kind, tree):
    return {"te_lora": jra.save_reference_te_lora, "unet_lora": jra.save_reference_unet_lora,
            "prefix": lambda t: {"token_embedding.weight": np.asarray(t)}}[kind](tree)


@pytest.mark.parametrize("kind", ["te_lora", "unet_lora", "prefix"])
def test_reference_layouts_match_jax(tmp_path, trees, kind):
    tree = trees[kind]
    want = _jax_save(kind, tree)
    got = tra.REFERENCE_FILES[kind][1](tree)
    assert set(got) == set(want) and len(got) > 0
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v)
    path = tmp_path / f"{kind}.pth"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in want.items()}, path)
    jkind, jtree = jra.load_reference_adapters(path)
    tkind, ttree = tra.load_reference_adapters(path)
    assert tkind == jkind == kind
    jl = [jtree] if kind == "prefix" else jax.tree_util.tree_leaves(jtree)
    tl = tree_leaves(ttree)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for j, t in zip(jax.tree_util.tree_leaves(tree), tl):  # the round trip returns the tree
        np.testing.assert_array_equal(t.numpy(), j)


def _train(tmp_path, out: str, *args: str):
    cfg = train_debias.parse_args(["--device", "cpu", "--tiny_smoke", "1", "--output_dir", str(tmp_path / out),
                                   "--checkpoint_tmp_every", "1", *args])
    return cfg, train_debias.main(cfg)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Three tiny CLI runs with a YAML config training the UNet and
    text-encoder LoRAs, evaluating every 2 steps: 3 steps unbroken; 2 steps,
    then resumed to 3 in the same output directory."""
    tmp = tmp_path_factory.mktemp("lifecycle")
    (tmp / "run.yaml").write_text("train_unet: true\ntrain_text_encoder: true\neval_interval: 2\n")
    conf = ["--debias_config", str(tmp / "run.yaml")]
    _, unbroken = _train(tmp, "a", "--max_train_steps", "3", *conf)
    _train(tmp, "b", "--max_train_steps", "2", *conf)
    cfg, resumed = _train(tmp, "b", "--max_train_steps", "3", "--resume_from_checkpoint", "1", *conf)
    return tmp, cfg, unbroken, resumed


def test_cli_resume_with_debias_config(run):
    tmp, cfg, unbroken, resumed = run
    assert set(resumed.adapters) == {"te_lora", "unet_lora"}
    assert (unbroken.step, unbroken.updates) == (resumed.step, resumed.updates) == (3, 3)
    for a, b in zip(tree_leaves(unbroken.adapters) + tree_leaves(unbroken.ema),
                    tree_leaves(resumed.adapters) + tree_leaves(resumed.ema), strict=True):
        assert torch.equal(a, b)
    records = [json.loads(x) for x in (tmp / "b" / "metrics.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in records if "train_loss" in r]
    assert steps == [1, 2, 3] and all("time" in r for r in records)
    assert {r["step"] for r in records if "eval_gender_gap" in r} == {2}
    assert {r["step"] for r in records if "eval_ema_gender_gap" in r} == {2}
    assert sorted(p.name for p in (tmp / "b" / "checkpoints" / "tmp").iterdir()) == ["2.pt", "3.pt"]


def test_export_checkpoint_round_trips(run):
    tmp, cfg, _, resumed = run
    out = export_checkpoint.main(export_checkpoint.ExportConfig(
        tiny_smoke=True, debias_config=cfg.debias_config, checkpoint_dir=str(tmp / "b" / "checkpoints"),
        reference_format=True, output_dir=str(tmp / "export")))
    assert sorted(p.name for p in out.iterdir()) == sorted(
        f"{n}{s}.{e}" for n, e in (("te_lora", "npz"), ("unet_lora", "npz"), ("text_encoder_lora", "pth"),
                                   ("unet_lora", "pth")) for s in ("", "_EMA"))
    for name in ("te_lora", "unet_lora"):
        for suffix, tree in (("", resumed.adapters[name]), ("_EMA", resumed.ema[name])):
            want = [t.detach().numpy() for t in tree_leaves(tree)]
            npz = tree_leaves(load_adapters(out / f"{name}{suffix}.npz"))
            stem = "text_encoder_lora" if name == "te_lora" else name
            kind, pth = tra.load_reference_adapters(out / f"{stem}{suffix}.pth")
            assert kind == name
            for w, a, b in zip(want, npz, tree_leaves(pth), strict=True):
                np.testing.assert_array_equal(a, w)
                np.testing.assert_array_equal(b.numpy(), w)
    # a template without the UNet LoRA does not take this checkpoint
    with pytest.raises(ValueError, match="tree"):
        export_checkpoint.main(export_checkpoint.ExportConfig(
            tiny_smoke=True, checkpoint_dir=str(tmp / "b" / "checkpoints")))


def test_gen_images_reads_reference_pth(run):
    """The exported `.pth` files give the same images as the run's `.npz`."""
    tmp, _, _, _ = run
    pngs = {}
    for name, unet, te in (("npz", tmp / "b" / "exported" / "unet_lora.npz", tmp / "b" / "exported" / "te_lora.npz"),
                           ("pth", tmp / "export" / "unet_lora.pth", tmp / "export" / "text_encoder_lora.pth")):
        written = gen_images.main(gen_images.GenImagesConfig(
            device="cpu", tiny_smoke=True, num_imgs_per_prompt=1, batch_size=1, num_denoising_steps=2,
            load_unet_lora_from=str(unet), load_text_encoder_lora_from=str(te), save_dir=str(tmp / f"gen_{name}")))
        pngs[name] = written[0].read_bytes()
    assert pngs["npz"] == pngs["pth"]
    with pytest.raises(ValueError, match="expected te_lora"):
        gen_images.main(gen_images.GenImagesConfig(
            device="cpu", tiny_smoke=True, load_text_encoder_lora_from=str(tmp / "export" / "unet_lora.pth")))


def test_export_of_the_prefix(tmp_path):
    """exp-2 writes its prefix table as `prefix_embedding.pth`, which
    `gen_images` reads as it reads `prefix.npz`."""
    _train(tmp_path, "p", "--experiment", "exp2", "--max_train_steps", "1")
    out = export_checkpoint.main(export_checkpoint.ExportConfig(
        experiment="exp2", tiny_smoke=True, checkpoint_dir=str(tmp_path / "p" / "checkpoints"),
        reference_format=True))
    kind, table = tra.load_reference_adapters(out / "prefix_embedding.pth")
    assert kind == "prefix"
    np.testing.assert_array_equal(table.numpy(), load_adapters(out / "prefix.npz")["prefix"])
    pngs = [gen_images.main(gen_images.GenImagesConfig(
        device="cpu", tiny_smoke=True, num_imgs_per_prompt=1, batch_size=1, num_denoising_steps=2,
        load_prefix_embedding_from=str(path), save_dir=str(tmp_path / f"gen_{path.suffix[1:]}")))[0].read_bytes()
        for path in (out / "prefix_embedding.pth", out / "prefix.npz")]
    assert pngs[0] == pngs[1]
