"""fairdiff_torch sampling slice against the JAX package: DPM-Solver++
tables and steps, masks, adapters, tokenizer, the tiny-config `generate`,
the gen_images CLI on the CPU, and the entry points' refusal to run on the
CPU unasked.

Inputs come from numpy seeds and go into both packages; float32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairdiff.adapters import lora as jlora
from fairdiff.adapters import prefix as jprefix
from fairdiff.io.adapters_io import save_adapters
from fairdiff.io.tokenizer import HashTokenizer as JHashTokenizer
from fairdiff.sampling import dpm_solver as jdpm
from fairdiff.sampling import pipeline as jpipe
from fairdiff.utils.rng import stable_hash as jstable_hash
from fairdiff_torch.adapters import lora as tlora
from fairdiff_torch.adapters import prefix as tprefix
from fairdiff_torch.device import resolve_device
from fairdiff_torch.io.adapters_io import load_adapters
from fairdiff_torch.io.tokenizer import HashTokenizer
from fairdiff_torch.io.from_jax import load_jax_params
from fairdiff_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from fairdiff_torch.sampling import dpm_solver as tdpm
from fairdiff_torch.sampling import pipeline as tpipe
from fairdiff_torch.tools import gen_images
from fairdiff_torch.utils.rng import stable_hash
from test_torch_models import random_tree, rel_err

torch.set_num_threads(1)


@pytest.mark.parametrize("steps", [2, 14, 30, 50])
def test_dpm_tables_match_jax(steps):
    cfg = jdpm.DPMSolverConfig()
    js, ts = jdpm.make_schedule(cfg), tdpm.make_schedule(tdpm.DPMSolverConfig())
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jdpm.timestep_grid(cfg, steps), tdpm.timestep_grid(cfg, steps))
    jb = jdpm.make_step_bundle(cfg, js, steps)
    tb = tdpm.make_step_bundle(tdpm.DPMSolverConfig(), ts, steps)
    for name in jb._fields:  # the same fp64 -> fp32 tables: exact
        np.testing.assert_array_equal(np.asarray(getattr(jb, name)), getattr(tb, name), err_msg=name)


@pytest.mark.parametrize("i", [0, 1, 5])
def test_dpm_step_matches_jax(i):
    """First-order (i=0) and second-order updates in fp32. Tolerance 1e-6
    relative: the same fp32 expressions, scalar exp from two libraries."""
    cfg = jdpm.DPMSolverConfig()
    jb = jdpm.make_step_bundle(cfg, jdpm.make_schedule(cfg), 20)
    tb = tdpm.make_step_bundle(tdpm.DPMSolverConfig(), tdpm.make_schedule(tdpm.DPMSolverConfig()), 20)
    rng = np.random.default_rng(i)
    x0, sample, m_prev = (rng.normal(size=(2, 4, 4, 4)).astype(np.float32) for _ in range(3))
    want = jdpm.dpm_step(*map(jnp.asarray, (x0, sample, m_prev)), jb, i)
    got = tdpm.dpm_step(*map(torch.from_numpy, (x0, sample, m_prev)), tb, i)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_denoise_matches_jax_scan():
    """The Python loop against `lax.scan` with a simple CFG eps function."""
    cfg = jdpm.DPMSolverConfig()
    jb = jdpm.make_step_bundle(cfg, jdpm.make_schedule(cfg), 6)
    tb = tdpm.make_step_bundle(tdpm.DPMSolverConfig(), tdpm.make_schedule(tdpm.DPMSolverConfig()), 6)
    lat = np.random.default_rng(3).normal(size=(2, 4, 4, 4)).astype(np.float32)

    def jeps(x2, t):
        return 0.3 * x2 + jnp.concatenate([jnp.zeros_like(x2[:2]), 0.01 * x2[2:] ** 2]) + t / 1000.0

    def teps(x2, t):
        return 0.3 * x2 + torch.cat([torch.zeros_like(x2[:2]), 0.01 * x2[2:] ** 2]) + t / 1000.0

    want = jdpm.denoise(jeps, jnp.asarray(lat), jb, guidance_scale=7.5)
    got = tdpm.denoise(teps, torch.from_numpy(lat), tb, guidance_scale=7.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_eos_attention_mask_matches_jax():
    ids = np.array([[0, 5, 63, 63, 63], [0, 5, 6, 7, 8], [0, 63, 1, 63, 2], [70, 71, 5, 63, 63]], np.int32)
    want = jpipe.eos_attention_mask(jnp.asarray(ids), 63)
    got = tpipe.eos_attention_mask(torch.from_numpy(ids), 63)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _clip_tree(seed=0):
    text = jpipe.SDConfig.tiny().text
    shapes = jax.eval_shape(
        jpipe.CLIPTextModel(text).init, jax.random.key(0), jnp.zeros((1, 4), jnp.int32)
    )["params"]
    return text, random_tree(shapes, seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_lora_matches_jax(dtype):
    """Merged text-encoder weights equal the JAX merge (fp32 sum, one
    rounding to the weight dtype): exact in fp32 up to the fp32 sum, and to
    the bf16 ulp in bf16."""
    text, tree = _clip_tree()
    lora = jlora.init_lora(tree, jlora.text_encoder_targets, 2, jax.random.key(1))
    rng = np.random.default_rng(4)
    lora = jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32), lora)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    merged_j = jlora.apply_lora(jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), tree), lora, 0.5)
    module = load_jax_params(CLIPTextModel(CLIPTextConfig(**vars(text))), tree).to(dtype)
    merged_t = tlora.apply_lora(module, lora, 0.5)
    assert len(merged_t) == 6 * text.num_hidden_layers  # q/k/v/out + fc1/fc2
    for name, w in merged_t.items():
        node = merged_j
        for part in name.split(".")[:-1]:
            node = node[part]
        want = np.asarray(node["kernel"].astype(jnp.float32)).T
        np.testing.assert_allclose(w.detach().float().numpy(), want, rtol=1e-6, atol=1e-6, err_msg=name)


def test_init_lora_is_a_noop_and_targets_attention():
    text, tree = _clip_tree()
    module = load_jax_params(CLIPTextModel(CLIPTextConfig(**vars(text))), tree)
    lora = tlora.init_lora(module, tlora.text_encoder_targets, 3, torch.Generator().manual_seed(0))
    jl = jlora.init_lora(tree, jlora.text_encoder_targets, 3, jax.random.key(0))
    shapes = lambda t: jax.tree_util.tree_map(lambda x: tuple(x.shape), t)
    assert shapes(lora) == shapes(jl)
    for name, w in tlora.apply_lora(module, lora).items():
        np.testing.assert_array_equal(w.detach().numpy(), module.state_dict()[name].numpy())


def test_prefix_ids_and_splice_match_jax():
    ids = np.array([[0, 5, 6, 63, 63, 63, 63, 63]], np.int32)
    want_ids = jprefix.prepend_prefix_ids(jnp.asarray(ids), 3, 64, 8)
    got_ids = tprefix.prepend_prefix_ids(torch.from_numpy(ids), 3, 64, 8)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    rng = np.random.default_rng(5)
    table = rng.normal(size=(64, 4)).astype(np.float32)
    prefix = rng.normal(size=(3, 4)).astype(np.float32)
    want = jprefix.splice_prefix_embeds(jnp.asarray(table), jnp.asarray(prefix), want_ids)
    got = tprefix.splice_prefix_embeds(torch.from_numpy(table), torch.from_numpy(prefix), got_ids)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hash_tokenizer_and_adapter_npz_match_jax(tmp_path):
    texts = ["A photo of a nurse", "", "a b c d e f g h i j k l m n o p q"]
    assert [stable_hash(t, 63) for t in texts] == [jstable_hash(t, 63) for t in texts]
    for padding in ("max_length", "longest"):
        want, got = JHashTokenizer()(texts, padding, 16), HashTokenizer()(texts, padding, 16)
        np.testing.assert_array_equal(got.input_ids, want.input_ids)
        np.testing.assert_array_equal(got.attention_mask, want.attention_mask)
    tree = {"a": {"b": {"down": np.ones((3, 2), np.float32), "up": np.zeros((2, 3), np.float32)}},
            "prefix": np.arange(8, dtype=np.float32).reshape(2, 4)}
    save_adapters(tmp_path / "ad.npz", tree)
    back = load_adapters(tmp_path / "ad.npz")
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_generate_matches_jax_tiny():
    """Tiny SDConfig, 2 steps, the same params, noise and adapters (UNet
    LoRA, text-encoder LoRA, soft prefix) on both sides: CLIP -> CFG UNet in
    the DPM loop -> VAE decode -> clamp. Tolerance 1e-4 relative L2 on the
    images: fp32 summation-order noise (~1e-6 per model) amplified by the
    solver's 1/alpha (~15 at t=999)."""
    cfg = jpipe.SDConfig.tiny()
    jsd = jpipe.StableDiffusion(cfg)
    params = random_tree(jax.eval_shape(jsd.init_params, jax.random.key(0)), seed=3)
    unet_lora = jlora.init_lora(params["unet"], jlora.unet_attention_targets, 2, jax.random.key(1))
    te_lora = jlora.init_lora(params["text_encoder"], jlora.text_encoder_targets, 2, jax.random.key(2))
    rng = np.random.default_rng(6)
    fill = lambda t: jax.tree_util.tree_map(lambda x: (0.1 * rng.normal(size=x.shape)).astype(np.float32), t)
    unet_lora, te_lora = fill(unet_lora), fill(te_lora)
    prefix = (0.3 * rng.normal(size=(2, cfg.text.hidden_size))).astype(np.float32)
    noises = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    cond = jprefix.prepend_prefix_ids(jnp.array([[0, 5, 6, 7] + [63] * 12], jnp.int32), 2, 64, 16)
    uncond = np.array([[0, 63] + [63] * 14], np.int32)
    want = jsd.generate(params, jnp.asarray(noises), cond, jnp.asarray(uncond), 2,
                        unet_lora=unet_lora, te_lora=te_lora, prefix_table=jnp.asarray(prefix))

    tsd = tpipe.StableDiffusion(tpipe.SDConfig.tiny(), device="cpu").load_jax(params)
    got = tsd.generate(noises, np.asarray(cond), uncond, 2, unet_lora=unet_lora,
                       te_lora=te_lora, prefix_table=torch.from_numpy(prefix))
    assert got.shape == (2, 64, 64, 3) and got.dtype == torch.float32
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-4


def test_gen_images_cli_writes_pngs_and_resumes(tmp_path):
    cfg = gen_images.parse_args([
        "--device", "cpu", "--tiny_smoke", "1", "--num_imgs_per_prompt", "3",
        "--batch_size", "2", "--num_denoising_steps", "2", "--save_dir", str(tmp_path),
    ])
    assert (cfg.num_imgs_per_prompt, cfg.tiny_smoke, cfg.guidance_scale) == (3, True, 7.5)
    written = gen_images.main(cfg)
    assert [p.name for p in written] == ["img_0.jpg", "img_1.jpg", "img_2.jpg"]
    first = [p.read_bytes() for p in written]
    assert all(b.startswith(b"\xff\xd8\xff\xe0\x00\x10JFIF") for b in first)  # as the JAX CLI writes them
    assert gen_images.main(cfg) == []  # everything exists: resume skips
    written[2].unlink()  # generated alone in its batch, as it will be again
    again = gen_images.main(cfg)  # only the missing image, with the same noise
    assert again == [written[2]] and again[0].read_bytes() == first[2]


def test_png_writer_round_trips(tmp_path):
    """The stdlib PNG writer against PIL's reader, pixel for pixel."""
    from PIL import Image

    from fairdiff_torch.io.images import save_png, to_uint8

    img = np.random.default_rng(7).uniform(-1.2, 1.2, size=(5, 7, 3)).astype(np.float32)
    path = tmp_path / "x.png"
    save_png(img, path)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), to_uint8(img))


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.StableDiffusion(tpipe.SDConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gen_images.main(dataclasses.replace(gen_images.GenImagesConfig(), tiny_smoke=True))
    assert resolve_device("cpu") == torch.device("cpu")
