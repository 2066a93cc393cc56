"""SDXL base 1.0 in the port, fp32 on the CPU at the tiny size of its topology
(`SDConfig.tiny_xl()`: three levels, no attention at the first, two layers
deep at the last, linear projections, two text encoders, the text_time
embedding), against the diffusers-layout reference: `torch_refs.TUNet` and
`TVAE` with SDXL's options, transformers' `CLIPTextModel` and
`CLIPTextModelWithProjection` (the published encoder classes), and the
benchmark's frozen DPM-Solver++ (`benchmark/reference/dpm_solver.py`, which
imports nothing of the port). The port's weights come from the reference's
state dicts through `io/sd_loader.py`'s SDXL mapping and `convert_sd`.

Tolerances: both sides are fp32 with other summation orders (the port's
attention takes fp32 logits from the same operands, its convolutions run
NCHW as the reference's), so a single call agrees to about 1e-6 relative;
each limit below is 1e-5, ten times that, and three denoising steps through
the decode 1e-4 (each step feeds the last one's rounding to the next).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import pytest
import torch
import transformers
from torch.func import functional_call

from benchmark.reference import dpm_solver as ref_dpm
from fairdiff_torch.adapters import lora as lora_lib
from fairdiff_torch.io.from_jax import load_jax_params
from fairdiff_torch.io.sd_loader import convert_unet, convert_vae
from fairdiff_torch.io.torch_convert import convert_clip_text
from fairdiff_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from fairdiff_torch.models.unet2d import UNet2DCondition, UNetConfig
from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion
from fairdiff_torch.tools import convert_sd, gen_images
from fairdiff_torch.utils import config as cfglib
from torch_refs import TUNet, TVAE

torch.set_num_threads(1)

CFG = SDConfig.tiny_xl()
TOL = 1e-5  # one fp32 call, other summation orders (module docstring)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def _seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every float tensor of `module` drawn from a numpy seed: matrices and
    kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2)
    (none 0 or 1, so a swapped leaf shows)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in sorted(module.named_parameters()):
            if p.dim() >= 2:
                x = rng.normal(size=p.shape) * p[0].numel() ** -0.5
            elif name.endswith("weight"):
                x = 1.0 + 0.1 * rng.normal(size=p.shape)
            else:
                x = 0.1 * rng.normal(size=p.shape)
            p.copy_(torch.from_numpy(x.astype(np.float32)))
    return module.eval()


def _hf_text(cfg: CLIPTextConfig, seed: int):
    kw = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
              num_hidden_layers=cfg.num_hidden_layers, num_attention_heads=cfg.num_attention_heads,
              max_position_embeddings=cfg.max_position_embeddings, hidden_act=cfg.hidden_act,
              layer_norm_eps=cfg.layer_norm_eps, eos_token_id=cfg.eos_token_id, bos_token_id=0,
              attn_implementation="eager")
    if cfg.projection_dim is None:
        return _seeded(transformers.CLIPTextModel(transformers.CLIPTextConfig(**kw)), seed)
    return _seeded(transformers.CLIPTextModelWithProjection(
        transformers.CLIPTextConfig(projection_dim=cfg.projection_dim, **kw)), seed)


@pytest.fixture(scope="module")
def ref():
    """The reference's models (diffusers and transformers names)."""
    return {"text_encoder": _hf_text(CFG.text, 1), "text_encoder_2": _hf_text(CFG.text_2, 2),
            "unet": _seeded(TUNet(CFG.unet), 3), "vae": _seeded(TVAE(CFG.vae), 4)}


def _port_from(ref: dict, **kw) -> StableDiffusion:
    sd = StableDiffusion(CFG, device="cpu", **kw)
    load_jax_params(sd.text_encoder, convert_clip_text(ref["text_encoder"].state_dict(), CFG.text.num_hidden_layers))
    load_jax_params(sd.text_encoder_2,
                    convert_clip_text(ref["text_encoder_2"].state_dict(), CFG.text_2.num_hidden_layers))
    load_jax_params(sd.unet, convert_unet(ref["unet"].state_dict(), CFG.unet))
    load_jax_params(sd.vae, convert_vae(ref["vae"].state_dict(), CFG.vae))
    return sd


@pytest.fixture(scope="module")
def port(ref):
    return _port_from(ref)


def _ids():
    """A prompt (BOS, words, eos padding) and the empty prompt (BOS, eos)."""
    eos, S = CFG.text.eos_token_id, CFG.text.max_position_embeddings
    cond = torch.tensor([[0, 5, 17, 9, 40] + [eos] * (S - 5)])
    uncond = torch.tensor([[0] + [eos] * (S - 1)])
    return cond, uncond


def _ref_context(ref, ids: torch.Tensor):
    """diffusers' SDXL `encode_prompt`: both encoders' hidden_states[-2] side
    by side, the second's projected pooled token; no attention mask."""
    a = ref["text_encoder"](ids, output_hidden_states=True)
    b = ref["text_encoder_2"](ids, output_hidden_states=True)
    return torch.cat([a.hidden_states[-2], b.hidden_states[-2]], dim=-1), b.text_embeds


def _ref_build_context(ref, n: int):
    cond_ids, _ = _ids()
    ctx, pooled = _ref_context(ref, cond_ids)
    # force_zeros_for_empty_prompt: the empty negative prompt is zeros
    context = torch.cat([torch.zeros_like(ctx).expand(n, -1, -1), ctx.expand(n, -1, -1)])
    pooled = torch.cat([torch.zeros_like(pooled).expand(n, -1), pooled.expand(n, -1)])
    size = 8 * CFG.unet.sample_size
    time_ids = torch.tensor([[size, size, 0, 0, size, size]], dtype=torch.float32).expand(2 * n, 6)
    return context, {"text_embeds": pooled, "time_ids": time_ids}


def _ref_eps(ref, lat2, t, context, added, weights=None):
    unet = ref["unet"]
    t = torch.as_tensor(t).expand(lat2.shape[0])
    out = functional_call(unet, dict(weights or {}), (lat2.permute(0, 3, 1, 2), t, context),
                          {"added_cond_kwargs": added})
    return out.permute(0, 2, 3, 1)


def test_encoders_match_transformers(ref, port):
    cond, uncond = _ids()
    ids = torch.cat([cond, uncond])
    with torch.no_grad():
        for name, mine in (("text_encoder", port.text_encoder), ("text_encoder_2", port.text_encoder_2)):
            theirs = ref[name](ids, output_hidden_states=True)
            got = mine(ids)
            assert rel(got["penultimate_hidden_state"], theirs.hidden_states[-2]) < TOL, name
            assert rel(got["last_hidden_state"], theirs.last_hidden_state) < TOL, name
        assert rel(got["text_embeds"], theirs.text_embeds) < TOL


def test_build_context_is_the_published_conditioning(ref, port):
    cond, uncond = _ids()
    with torch.no_grad():
        context, key_mask, added = port.build_context(cond, uncond, 3)
        want_ctx, want_added = _ref_build_context(ref, 3)
    assert key_mask is None  # SDXL's pipeline masks no padding
    assert context.shape == (6, CFG.text.max_position_embeddings, CFG.unet.cross_attention_dim)
    assert torch.equal(context[:3], torch.zeros_like(context[:3]))
    assert torch.equal(added["text_embeds"][:3], torch.zeros_like(added["text_embeds"][:3]))
    assert rel(context, want_ctx) < TOL and rel(added["text_embeds"], want_added["text_embeds"]) < TOL
    assert torch.equal(added["time_ids"], want_added["time_ids"])
    # a non-empty negative prompt is encoded, not zeroed
    with torch.no_grad():
        ctx2, _, added2 = port.build_context(cond, cond, 1)
    assert torch.equal(ctx2[0], ctx2[1]) and torch.equal(added2["text_embeds"][0], added2["text_embeds"][1])


@pytest.mark.parametrize("t", [999, 17])
def test_unet_matches_reference(ref, port, t):
    g = torch.Generator().manual_seed(t)
    lat2 = torch.randn(4, 8, 8, 4, generator=g)
    context = torch.randn(4, CFG.text.max_position_embeddings, CFG.unet.cross_attention_dim, generator=g)
    added = {"text_embeds": torch.randn(4, CFG.text_2.projection_dim, generator=g),
             "time_ids": torch.tensor([[64.0, 64, 0, 0, 64, 64], [32, 48, 4, 0, 64, 64]]).repeat(2, 1)}
    with torch.no_grad():
        got = port.unet_eps(lat2, t, context, None, added_cond=added)
        want = _ref_eps(ref, lat2, t, context, added)
    assert rel(got, want) < TOL


def test_unet_without_added_conditioning_raises(port):
    with pytest.raises(ValueError, match="added_cond"):
        port.unet(torch.zeros(2, 8, 8, 4), 1, torch.zeros(2, 4, CFG.unet.cross_attention_dim))


def test_generate_three_steps_matches_reference(ref, port):
    cond, uncond = _ids()
    noises = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got, latents, _ = port.generate(noises, cond, uncond, 3, guidance_scale=7.5, return_latents=True)
        context, added = _ref_build_context(ref, 2)
        bundle = ref_dpm.make_step_bundle(ref_dpm.DPMSolverConfig(), ref_dpm.make_schedule(), 3)
        want_lat = ref_dpm.denoise(lambda lat2, t: _ref_eps(ref, lat2, t, context, added), noises, bundle,
                                   guidance_scale=7.5)
        want = ref["vae"].decode((want_lat / CFG.vae.scaling_factor).permute(0, 3, 1, 2))
        want = want.permute(0, 2, 3, 1).clamp(-1, 1)
    # three steps and the decode: each step carries the last one's rounding
    assert rel(latents, want_lat) < 1e-4
    assert rel(got, want) < 1e-4


def _diffusers_name(port_name: str) -> str:
    """A port UNet parameter name in diffusers' layout (attention layers)."""
    name = re.sub(r"^down_(\d+)_attn_(\d+)\.", r"down_blocks.\1.attentions.\2.", port_name)
    name = re.sub(r"^up_(\d+)_attn_(\d+)\.", r"up_blocks.\1.attentions.\2.", name)
    name = re.sub(r"^mid_attn_0\.", "mid_block.attentions.0.", name)
    name = re.sub(r"transformer_blocks_(\d+)\.", r"transformer_blocks.\1.", name)
    return name.replace(".to_out.", ".to_out.0.")


def _nodes(tree: dict):
    if "down" in tree:
        yield tree
        return
    for v in tree.values():
        yield from _nodes(v)


def _lora(unet: torch.nn.Module, rank: int = 2) -> dict:
    """A UNet-attention LoRA with `up` nonzero, fp32, leaves requiring grad."""
    g = torch.Generator().manual_seed(11)
    tree = lora_lib.init_lora(unet, lora_lib.unet_attention_targets, rank, g)
    for node in _nodes(tree):
        node["up"] = (torch.randn(node["up"].shape, generator=g) * 0.05).requires_grad_()
        node["down"].requires_grad_()
    return tree


@pytest.mark.parametrize("remat", [False, True])
def test_input_and_lora_gradients_match_reference(ref, remat):
    """The gradients the later training PR needs: into the UNet's latent
    input, the context, the pooled vector and a merged attention LoRA, through
    `unet_eps` (remat recomputing each N-layer stack as one block)."""
    sd = _port_from(ref, remat=remat)
    g = torch.Generator().manual_seed(3)
    lat2 = torch.randn(2, 8, 8, 4, generator=g)
    ctx = torch.randn(2, CFG.text.max_position_embeddings, CFG.unet.cross_attention_dim, generator=g)
    pooled = torch.randn(2, CFG.text_2.projection_dim, generator=g)
    time_ids = torch.tensor([[64.0, 64, 0, 0, 64, 64]]).expand(2, 6)
    w = torch.randn(2, 8, 8, 4, generator=g)
    tree = _lora(sd.unet)
    leaves = [x for node in _nodes(tree) for x in (node["down"], node["up"])]

    def grads(eps_of):
        inputs = [x.clone().requires_grad_() for x in (lat2, ctx, pooled)]
        loss = (eps_of(*inputs) * w).sum()
        return torch.autograd.grad(loss, inputs + leaves)

    got = grads(lambda x, c, p: sd.unet_eps(x, 500, c, None, unet_weights=lora_lib.apply_lora(sd.unet, tree),
                                            added_cond={"text_embeds": p, "time_ids": time_ids}))
    # q, k, v and out of both attentions of the 17 layers: 2 + 4 down, 2 mid, 6 + 3 up
    assert len(lora_lib.lora_deltas(sd.unet, tree)) == 8 * 17
    own = dict(ref["unet"].named_parameters())

    def ref_eps(x, c, p):
        merged = {_diffusers_name(k): own[_diffusers_name(k)] + d for k, d in lora_lib.lora_deltas(sd.unet, tree).items()}
        return _ref_eps(ref, x, 500, c, {"text_embeds": p, "time_ids": time_ids}, merged)

    want = grads(ref_eps)
    for i, (a, b) in enumerate(zip(got, want)):
        assert rel(a, b) < TOL, i


def test_published_widths_on_the_meta_device():
    """`UNetConfig.sdxl()` and `CLIPTextConfig.sdxl_2()` build SDXL base
    1.0's published parameters: the UNet's 2,567,463,684 (its
    `unet/diffusion_pytorch_model.safetensors`), 70 transformer layers (60 at
    1280 channels, 10 at 640), and encoders of transformers' published
    classes' sizes."""
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig.sdxl())
        te2 = CLIPTextModel(CLIPTextConfig.sdxl_2())
        hf2 = transformers.CLIPTextModelWithProjection(transformers.CLIPTextConfig(
            hidden_size=1280, intermediate_size=5120, num_hidden_layers=32, num_attention_heads=20,
            hidden_act="gelu", projection_dim=1280))
    shapes = {k: tuple(p.shape) for k, p in unet.named_parameters()}
    assert sum(p.numel() for p in unet.parameters()) == 2_567_463_684
    assert shapes["add_embedding.linear_1.weight"] == (1280, 2816)
    assert shapes["add_embedding.linear_2.weight"] == (1280, 1280)
    assert shapes["down_2_attn_0.proj_in.weight"] == (1280, 1280)
    assert shapes["down_1_attn_1.proj_out.weight"] == (640, 640)
    assert shapes["mid_attn_0.transformer_blocks_9.attn2.to_k.weight"] == (1280, 2048)
    assert shapes["up_0_attn_2.transformer_blocks_9.ff.proj.weight"] == (10240, 1280)
    assert not any(k.startswith(("down_0_attn", "up_2_attn")) for k in shapes)
    layers = {k.split(".transformer_blocks_")[0] + "/" + k.split(".transformer_blocks_")[1].split(".")[0]
              for k in shapes if ".transformer_blocks_" in k}
    width = {layer: shapes[layer.split("/")[0] + ".proj_in.weight"][0] for layer in layers}
    assert len(layers) == 70 and sorted(set(width.values())) == [640, 1280]
    assert sum(w == 1280 for w in width.values()) == 60
    heads = {m.heads * 64 for m in unet.modules() if hasattr(m, "heads")}
    assert heads == {640, 1280}  # head dim 64 at both widths
    assert sum(p.numel() for p in te2.parameters()) == sum(p.numel() for p in hf2.parameters()) == 694_659_840
    assert list(StableDiffusion(CFG, device="cpu").models()) == ["text_encoder", "text_encoder_2", "unet", "vae"]
    assert SDConfig.sdxl().vae.scaling_factor == 0.13025 and SDConfig.sdxl().image_size() == 1024


def test_sd15_keeps_its_layout():
    """SD-1.5 builds what it built: conv projections, one layer a stack, no
    added embedding, three models."""
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig.sd15())
    names = {k for k, _ in unet.named_parameters()}
    assert unet.down_0_attn_0.proj_in.weight.shape == (320, 320, 1, 1)
    assert not any("transformer_blocks_1" in k or k.startswith("add_embedding") for k in names)
    assert list(StableDiffusion(SDConfig.tiny(), device="cpu").models()) == ["text_encoder", "unet", "vae"]


def test_convert_sd_then_gen_images_runs_the_sdxl_preset(tmp_path, ref):
    """A tiny SDXL diffusers directory (with `text_encoder_2/`) through
    `convert_sd --preset tiny_xl`, then `gen_images --preset sdxl --tiny_smoke
    1 --model_dir`: the store holds the four models, loads strictly, and
    the images differ from those of seeded weights."""
    for name, m in ref.items():
        (tmp_path / "sd" / name).mkdir(parents=True)
        torch.save(m.state_dict(), tmp_path / "sd" / name / "pytorch_model.bin")
    convert_sd.main(cfglib.cli_parse(convert_sd.ConvertConfig, [
        "--sd_dir", str(tmp_path / "sd"), "--out_dir", str(tmp_path / "store"), "--preset", "tiny_xl"]))
    assert sorted(p.name for p in (tmp_path / "store").iterdir()) == [
        "text_encoder.pt", "text_encoder_2.pt", "unet.pt", "vae.pt"]
    loaded = StableDiffusion(CFG, device="cpu").load_params(tmp_path / "store")
    want = _port_from(ref)
    for name, m in want.models().items():
        for k, v in m.state_dict().items():
            assert torch.equal(loaded.models()[name].state_dict()[k], v), f"{name}.{k}"
    common = ["--device", "cpu", "--preset", "sdxl", "--tiny_smoke", "1", "--num_imgs_per_prompt", "2",
              "--batch_size", "2", "--num_denoising_steps", "2"]
    stored = gen_images.main(gen_images.parse_args(common + ["--save_dir", str(tmp_path / "stored"),
                                                            "--model_dir", str(tmp_path / "store")]))
    random = gen_images.main(gen_images.parse_args(common + ["--save_dir", str(tmp_path / "random")]))
    assert [p.name for p in stored] == ["img_0.jpg", "img_1.jpg"]
    assert stored[0].read_bytes() != random[0].read_bytes()
    with pytest.raises(ValueError, match="preset"):
        gen_images.main(gen_images.parse_args(common[:2] + ["--preset", "sd3"]))


def test_the_trainer_refuses_sdxl():
    from fairdiff_torch.training.debias import DebiasConfig, DebiasTrainer

    sd = StableDiffusion(dataclasses.replace(CFG), device="cpu")
    with pytest.raises(NotImplementedError, match="SDXL"):
        DebiasTrainer(sd, None, DebiasConfig())
