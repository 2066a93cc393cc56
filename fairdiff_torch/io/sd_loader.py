"""Stable Diffusion checkpoint conversion, diffusers layout -> parameter
trees (a copy of fairdiff/io/sd_loader.py, widened to SDXL base 1.0).

The reference loads SD-1.5 with `from_pretrained`. Here the state dicts of
the `unet/`, `vae/` and `text_encoder/` subfolders (and SDXL's
`text_encoder_2/`, through `torch_convert.convert_clip_text`) are remapped by
name into the JAX package's tree layout (HWIO convs, [in, out] kernels),
which `io.from_jax` loads into the port's modules. SDXL's UNet adds
`transformer_blocks.{k}` for k below each level's depth, linear
`proj_in`/`proj_out`, and `add_embedding.linear_{1,2}`. Pure numpy.
"""

from __future__ import annotations

from typing import Any

from fairdiff_torch.io import torch_convert as tc
from fairdiff_torch.models.autoencoder_kl import VAEConfig
from fairdiff_torch.models.unet2d import UNetConfig


def _attn_block(sd: tc.Tensors, p: str) -> dict:
    """BasicTransformerBlock params from diffusers naming."""
    out: dict[str, Any] = {}
    for norm in ("norm1", "norm2", "norm3"):
        out[norm] = tc.norm(sd, f"{p}.{norm}")
    for attn in ("attn1", "attn2"):
        out[attn] = {
            "to_q": tc.linear(sd, f"{p}.{attn}.to_q"),
            "to_k": tc.linear(sd, f"{p}.{attn}.to_k"),
            "to_v": tc.linear(sd, f"{p}.{attn}.to_v"),
            "to_out": tc.linear(sd, f"{p}.{attn}.to_out.0"),
        }
    out["ff"] = {
        "proj": tc.linear(sd, f"{p}.ff.net.0.proj"),
        "out": tc.linear(sd, f"{p}.ff.net.2"),
    }
    return out


def _transformer2d(sd: tc.Tensors, p: str, depth: int, linear: bool) -> dict:
    proj = tc.linear if linear else tc.conv
    out = {
        "norm": tc.norm(sd, f"{p}.norm"),
        "proj_in": proj(sd, f"{p}.proj_in"),
        "proj_out": proj(sd, f"{p}.proj_out"),
    }
    for k in range(depth):
        out[f"transformer_blocks_{k}"] = _attn_block(sd, f"{p}.transformer_blocks.{k}")
    return out


def _resnet(sd: tc.Tensors, p: str) -> dict:
    out = {
        "norm1": tc.norm(sd, f"{p}.norm1"),
        "conv1": tc.conv(sd, f"{p}.conv1"),
        "norm2": tc.norm(sd, f"{p}.norm2"),
        "conv2": tc.conv(sd, f"{p}.conv2"),
    }
    if f"{p}.time_emb_proj.weight" in sd:
        out["time_emb_proj"] = tc.linear(sd, f"{p}.time_emb_proj")
    if f"{p}.conv_shortcut.weight" in sd:
        out["conv_shortcut"] = tc.conv(sd, f"{p}.conv_shortcut")
    return out


def convert_unet(sd: tc.Tensors, config: UNetConfig) -> dict:
    """diffusers `UNet2DConditionModel.state_dict()` -> UNet2DCondition params."""
    n_blocks = len(config.block_out_channels)
    params: dict[str, Any] = {
        "conv_in": tc.conv(sd, "conv_in"),
        "conv_out": tc.conv(sd, "conv_out"),
        "conv_norm_out": tc.norm(sd, "conv_norm_out"),
        "time_embedding": {
            "linear_1": tc.linear(sd, "time_embedding.linear_1"),
            "linear_2": tc.linear(sd, "time_embedding.linear_2"),
        },
    }
    if config.addition_embed_type == "text_time":
        params["add_embedding"] = {
            "linear_1": tc.linear(sd, "add_embedding.linear_1"),
            "linear_2": tc.linear(sd, "add_embedding.linear_2"),
        }
    attn = lambda p, level: _transformer2d(sd, p, config.depth(level), config.use_linear_projection)
    for i in range(n_blocks):
        for j in range(config.layers_per_block):
            params[f"down_{i}_resnet_{j}"] = _resnet(sd, f"down_blocks.{i}.resnets.{j}")
            if config.cross_attn_down[i]:
                params[f"down_{i}_attn_{j}"] = attn(f"down_blocks.{i}.attentions.{j}", i)
        if i < n_blocks - 1:
            params[f"down_{i}_downsample"] = {
                "conv": tc.conv(sd, f"down_blocks.{i}.downsamplers.0.conv")
            }
    params["mid_resnet_0"] = _resnet(sd, "mid_block.resnets.0")
    params["mid_resnet_1"] = _resnet(sd, "mid_block.resnets.1")
    params["mid_attn_0"] = attn("mid_block.attentions.0", n_blocks - 1)
    for i in range(n_blocks):
        for j in range(config.layers_per_block + 1):
            params[f"up_{i}_resnet_{j}"] = _resnet(sd, f"up_blocks.{i}.resnets.{j}")
            if config.cross_attn_up[i]:
                params[f"up_{i}_attn_{j}"] = attn(f"up_blocks.{i}.attentions.{j}", n_blocks - 1 - i)
        if i < n_blocks - 1:
            params[f"up_{i}_upsample"] = {
                "conv": tc.conv(sd, f"up_blocks.{i}.upsamplers.0.conv")
            }
    return params


def _vae_attn(sd: tc.Tensors, p: str) -> dict:
    # diffusers renamed VAE attention params across versions
    legacy = f"{p}.query.weight" in sd
    names = (
        {"q": "query", "k": "key", "v": "value", "o": "proj_attn"}
        if legacy
        else {"q": "to_q", "k": "to_k", "v": "to_v", "o": "to_out.0"}
    )

    def lin(key):
        w = tc._np(sd[f"{p}.{names[key]}.weight"])
        if w.ndim == 4:  # very old ckpts store 1x1 convs
            w = w[:, :, 0, 0]
        return {"kernel": w.T, "bias": tc._np(sd[f"{p}.{names[key]}.bias"])}

    return {
        "group_norm": tc.norm(sd, f"{p}.group_norm"),
        "to_q": lin("q"),
        "to_k": lin("k"),
        "to_v": lin("v"),
        "to_out": lin("o"),
    }


def _vae_half(sd: tc.Tensors, config: VAEConfig, encoder: bool) -> dict:
    n = len(config.block_out_channels)
    side = "down" if encoder else "up"
    layers = config.layers_per_block + (0 if encoder else 1)
    params: dict[str, Any] = {
        "conv_in": tc.conv(sd, "conv_in"),
        "conv_out": tc.conv(sd, "conv_out"),
        "conv_norm_out": tc.norm(sd, "conv_norm_out"),
        "mid_resnet_0": _resnet(sd, "mid_block.resnets.0"),
        "mid_resnet_1": _resnet(sd, "mid_block.resnets.1"),
        "mid_attn": _vae_attn(sd, "mid_block.attentions.0"),
    }
    for i in range(n):
        for j in range(layers):
            params[f"{side}_{i}_resnet_{j}"] = _resnet(sd, f"{side}_blocks.{i}.resnets.{j}")
        if i < n - 1:
            sampler = "downsamplers" if encoder else "upsamplers"
            key = f"{side}_{i}_{'downsample' if encoder else 'upsample'}"
            conv = tc.conv(sd, f"{side}_blocks.{i}.{sampler}.0.conv")
            params[key] = conv if encoder else {"conv": conv}
    return params


def convert_vae(sd: tc.Tensors, config: VAEConfig) -> dict:
    """diffusers `AutoencoderKL.state_dict()` -> AutoencoderKL params."""
    enc = {k.removeprefix("encoder."): v for k, v in sd.items() if k.startswith("encoder.")}
    dec = {k.removeprefix("decoder."): v for k, v in sd.items() if k.startswith("decoder.")}
    return {
        "encoder": _vae_half(enc, config, encoder=True),
        "decoder": _vae_half(dec, config, encoder=False),
        "quant_conv": tc.conv(sd, "quant_conv"),
        "post_quant_conv": tc.conv(sd, "post_quant_conv"),
    }
