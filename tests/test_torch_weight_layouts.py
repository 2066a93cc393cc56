"""`chip_smoke`'s writers of the reference's external weight layouts, held
to the layouts' own modules.

`[weights]` writes SD-1.5, CLIP-ViT-H/14 and DINOv2 ViT-B/14 at full width
from the port's modules in the layouts the reference reads (diffusers'
UNet2DConditionModel and AutoencoderKL, transformers' CLIPTextModel,
CLIPVisionModelWithProjection and Dinov2Model), then converts them back.
Here, at full width and on `torch.device("meta")` (no memory), each writer's
key set and shapes equal those of the layout's own module:
`tests/torch_refs.py`'s TUNet/TVAE (diffusers' key layout) and the
transformers models. At the tiny configs, the writer and the port's
converter round-trip the weights exactly; the safetensors writer is read
back by the `safetensors` package.
"""

import numpy as np
import pytest
import torch
import transformers

import chip_smoke
from fairdiff.sampling.pipeline import SDConfig as JSDConfig
from fairdiff_torch.io import feature_models, sd_loader, torch_convert
from fairdiff_torch.io.from_jax import state_dict_from_jax
from fairdiff_torch.models.autoencoder_kl import AutoencoderKL
from fairdiff_torch.models.clip_text import CLIPTextModel
from fairdiff_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
from fairdiff_torch.models.dinov2 import DINOv2Config, DINOv2Model
from fairdiff_torch.models.layers import init_weights
from fairdiff_torch.models.unet2d import UNet2DCondition
from fairdiff_torch.sampling.pipeline import SDConfig
from torch_refs import TUNet, TVAE

torch.set_num_threads(1)


def hf_text(cfg) -> transformers.CLIPTextModel:
    return transformers.CLIPTextModel(transformers.CLIPTextConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers, num_attention_heads=cfg.num_attention_heads,
        max_position_embeddings=cfg.max_position_embeddings, hidden_act=cfg.hidden_act))


def hf_vision(cfg: CLIPVisionConfig) -> transformers.CLIPVisionModelWithProjection:
    return transformers.CLIPVisionModelWithProjection(transformers.CLIPVisionConfig(
        hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers, num_attention_heads=cfg.num_attention_heads,
        image_size=cfg.image_size, patch_size=cfg.patch_size, projection_dim=cfg.projection_dim,
        hidden_act=cfg.hidden_act))


def hf_dinov2(cfg: DINOv2Config) -> transformers.Dinov2Model:
    return transformers.Dinov2Model(transformers.Dinov2Config(
        hidden_size=cfg.hidden_size, mlp_ratio=cfg.intermediate_size // cfg.hidden_size,
        num_hidden_layers=cfg.num_hidden_layers, num_attention_heads=cfg.num_attention_heads,
        patch_size=cfg.patch_size, image_size=cfg.pos_embed_size * cfg.patch_size))


def _layouts(sd_cfg, jsd_cfg, vision_cfg, dino_cfg):
    """name -> (port module, chip_smoke's writer, a constructor of the
    layout's own module)."""
    return {
        "unet": (UNet2DCondition(sd_cfg.unet), chip_smoke.diffusers_unet, lambda: TUNet(jsd_cfg.unet)),
        "vae": (AutoencoderKL(sd_cfg.vae), chip_smoke.diffusers_vae, lambda: TVAE(jsd_cfg.vae)),
        "text_encoder": (CLIPTextModel(sd_cfg.text), chip_smoke.hf_clip_text, lambda: hf_text(sd_cfg.text)),
        "clip_vision": (CLIPVisionModel(vision_cfg), chip_smoke.hf_clip_vision, lambda: hf_vision(vision_cfg)),
        "dinov2": (DINOv2Model(dino_cfg), chip_smoke.hf_dinov2, lambda: hf_dinov2(dino_cfg)),
    }


@pytest.mark.parametrize("name", ["unet", "vae", "text_encoder", "clip_vision", "dinov2"])
def test_writers_emit_the_full_width_layouts(name):
    with torch.device("meta"):
        module, writer, reference = _layouts(SDConfig.sd15(), JSDConfig.sd15(), CLIPVisionConfig.vit_h14(),
                                             DINOv2Config.vitb14())[name]
        got = {k: tuple(v.shape) for k, v in writer(module.state_dict()).items()}
        want = {k: tuple(v.shape) for k, v in reference().state_dict().items()}
    assert sorted(got) == sorted(want)
    assert got == want


_CONVERTERS = {
    "unet": lambda sd: sd_loader.convert_unet(sd, SDConfig.tiny().unet),
    "vae": lambda sd: sd_loader.convert_vae(sd, SDConfig.tiny().vae),
    "text_encoder": lambda sd: torch_convert.convert_clip_text(sd, SDConfig.tiny().text.num_hidden_layers),
    "clip_vision": lambda sd: feature_models.convert_clip_vision(sd, CLIPVisionConfig.tiny().num_hidden_layers),
    "dinov2": lambda sd: feature_models.convert_dinov2(sd, DINOv2Config.tiny().num_hidden_layers),
}


@pytest.mark.parametrize("name", sorted(_CONVERTERS))
def test_writer_and_converter_round_trip_exactly(name):
    """Tiny configs, seeded weights: writer then converter gives back every
    tensor bit for bit, and the written keys are the layout's own."""
    module, writer, reference = _layouts(SDConfig.tiny(), JSDConfig.tiny(), CLIPVisionConfig.tiny(),
                                         DINOv2Config.tiny())[name]
    init_weights(module, torch.Generator().manual_seed(3))
    state = module.state_dict()
    written = writer(state)
    assert set(written) == set(reference().state_dict())
    back = state_dict_from_jax(_CONVERTERS[name](written))
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k


def test_safetensors_writer_reads_back_with_the_package(tmp_path):
    from safetensors.torch import load_file
    from safetensors import safe_open

    rng = np.random.default_rng(0)
    tensors = {
        "a.f32": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)),
        "b.bf16": torch.from_numpy(rng.normal(size=(7,)).astype(np.float32)).bfloat16(),
        "c.f16": torch.from_numpy(rng.normal(size=(2, 1, 3)).astype(np.float16)),
        "d.i64": torch.arange(-4, 5, dtype=torch.int64),
        "e.scalar": torch.tensor(2.5),
    }
    path = tmp_path / "w.safetensors"
    chip_smoke.save_safetensors(tensors, path, {"format": "pt"})
    got = load_file(path)
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    with safe_open(path, "pt") as f:
        assert f.metadata() == {"format": "pt"}
