"""SDXL base 1.0 for the benchmark's reference: plain fp32 modules with the
port's parameter names (fairdiff_torch's `UNetConfig.sdxl()`,
`CLIPTextConfig.sdxl_2()`, `SDConfig.sdxl()`), written from diffusers'
`UNet2DConditionModel` and `StableDiffusionXLPipeline` and transformers'
`CLIPTextModelWithProjection`, on the SD-1.5 reference's blocks
(`reference/unet2d.py`, `clip_text.py`, `autoencoder_kl.py`,
`dpm_solver.py`, `lora.py`). Nothing of the port is imported.

- UNet: a head count and a transformer depth per level (the mid block
  takes the last, the up blocks the reversed lists), `transformer_blocks_0..`
  between Linear `proj_in`/`proj_out` on the token rows, and the "text_time"
  added embedding: `add_embedding(cat[pooled, sinusoids of the six time
  ids])` summed into the time embedding.
- Text: each encoder's penultimate hidden state (the input of its last
  layer); the second's pooled token (argmax of the ids) through its biasless
  `text_projection`. No padding mask anywhere, as the published pipeline.
- Conditioning: the context is both penultimate states side by side; an
  empty prompt (BOS then eos) conditions as zeros
  (`force_zeros_for_empty_prompt`); the time ids are (H, W, 0, 0, H, W).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from benchmark.reference import dpm_solver as dpm
from benchmark.reference import lora as lora_lib
from benchmark.reference.autoencoder_kl import AutoencoderKL, VAEConfig
from benchmark.reference.clip_text import CLIPEncoderLayer, CLIPTextConfig
from benchmark.reference.layers import make_causal_mask
from benchmark.reference.unet2d import (
    BasicTransformerBlock,
    Downsample2D,
    ResnetBlock2D,
    TimestepEmbedding,
    Upsample2D,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class TextConfig(CLIPTextConfig):
    projection_dim: Optional[int] = None


class TextEncoder(nn.Module):
    """CLIP's text tower -> {"penultimate": [B, S, C], "text_embeds": [B, P]
    where it has a projection}."""

    def __init__(self, config: TextConfig):
        super().__init__()
        self.config = config
        c = config.hidden_size
        self.token_embedding = nn.Embedding(config.vocab_size, c)
        self.position_embedding = nn.Parameter(torch.zeros(config.max_position_embeddings, c))
        for i in range(config.num_hidden_layers):
            self.add_module(f"layers_{i}", CLIPEncoderLayer(config))
        self.final_layer_norm = nn.LayerNorm(c, eps=config.layer_norm_eps)
        if config.projection_dim is not None:
            self.text_projection = nn.Linear(c, config.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor) -> dict[str, torch.Tensor]:
        S = input_ids.shape[1]
        x = self.token_embedding(input_ids)
        x = x + self.position_embedding[:S].to(x.dtype)
        bias = make_causal_mask(S, device=x.device)
        n = self.config.num_hidden_layers
        for i in range(n - 1):
            x = getattr(self, f"layers_{i}")(x, bias)
        out = {"penultimate": x}
        if self.config.projection_dim is not None:
            last = self.final_layer_norm(getattr(self, f"layers_{n - 1}")(x, bias))
            pooled = last[torch.arange(last.shape[0], device=last.device), input_ids.argmax(dim=-1)]
            out["text_embeds"] = self.text_projection(pooled)
        return out


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 128
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 2048
    attention_head_dim: tuple[int, ...] = (5, 10, 20)  # head counts, as diffusers names them
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    cross_attn_down: tuple[bool, ...] = (False, True, True)
    cross_attn_up: tuple[bool, ...] = (True, True, False)
    transformer_layers_per_block: tuple[int, ...] = (1, 2, 10)
    use_linear_projection: bool = True
    addition_embed_type: str = "text_time"
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816


class Transformer2D(nn.Module):
    """GN -> NCHW to tokens -> Linear proj_in -> `depth` blocks -> Linear
    proj_out -> NCHW + residual."""

    def __init__(self, channels: int, heads: int, context_dim: int, groups: int, depth: int):
        super().__init__()
        self.depth = depth
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        for k in range(depth):
            self.add_module(f"transformer_blocks_{k}", BasicTransformerBlock(channels, heads, context_dim))
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C))
        for k in range(self.depth):
            h = getattr(self, f"transformer_blocks_{k}")(h, context)
        return self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2) + x


class UNet2DCondition(nn.Module):
    """forward(latents [B,H,W,4] NHWC, timesteps [B] or scalar, context
    [B,T,2048], text_embeds [B,1280], time_ids [B,6]) -> eps NHWC."""

    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        self.config = cfg = config
        ch, ctx, groups, eps = cfg.block_out_channels, cfg.cross_attention_dim, cfg.norm_num_groups, cfg.norm_eps
        temb_dim = ch[0] * 4
        self.time_embedding = TimestepEmbedding(ch[0], temb_dim)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb_dim)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        attn = lambda level, c: Transformer2D(c, cfg.attention_head_dim[level], ctx, groups,
                                              cfg.transformer_layers_per_block[level])
        skip_ch, cur = [ch[0]], ch[0]
        for i, out_ch in enumerate(ch):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_resnet_{j}", ResnetBlock2D(cur, out_ch, groups, eps, temb_dim))
                cur = out_ch
                if cfg.cross_attn_down[i]:
                    self.add_module(f"down_{i}_attn_{j}", attn(i, cur))
                skip_ch.append(cur)
            if i < len(ch) - 1:
                self.add_module(f"down_{i}_downsample", Downsample2D(cur))
                skip_ch.append(cur)
        self.mid_resnet_0 = ResnetBlock2D(cur, cur, groups, eps, temb_dim)
        self.mid_attn_0 = attn(len(ch) - 1, cur)
        self.mid_resnet_1 = ResnetBlock2D(cur, cur, groups, eps, temb_dim)
        for i, out_ch in enumerate(reversed(ch)):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_resnet_{j}", ResnetBlock2D(cur + skip_ch.pop(), out_ch, groups, eps, temb_dim))
                cur = out_ch
                if cfg.cross_attn_up[i]:
                    self.add_module(f"up_{i}_attn_{j}", attn(len(ch) - 1 - i, cur))
            if i < len(ch) - 1:
                self.add_module(f"up_{i}_upsample", Upsample2D(cur))
        self.conv_norm_out = nn.GroupNorm(groups, cur, eps=eps)
        self.conv_out = nn.Conv2d(cur, cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, context, text_embeds, time_ids) -> torch.Tensor:
        cfg = self.config
        ch = cfg.block_out_channels
        dtype = self.conv_in.weight.dtype
        B = sample.shape[0]
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(B)
        temb = self.time_embedding(timestep_embedding(timesteps, ch[0], cfg.flip_sin_to_cos, cfg.freq_shift).to(dtype))
        time_embeds = timestep_embedding(time_ids.flatten(), cfg.addition_time_embed_dim, cfg.flip_sin_to_cos,
                                         cfg.freq_shift).reshape(B, -1)
        temb = temb + self.add_embedding(torch.cat([text_embeds.float(), time_embeds], dim=-1).to(dtype))
        context = context.to(dtype)
        h = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))
        skips = [h]
        for i in range(len(ch)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_resnet_{j}")(h, temb)
                if cfg.cross_attn_down[i]:
                    h = getattr(self, f"down_{i}_attn_{j}")(h, context)
                skips.append(h)
            if i < len(ch) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                skips.append(h)
        h = self.mid_resnet_1(self.mid_attn_0(self.mid_resnet_0(h, temb), context), temb)
        for i in range(len(ch)):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{i}_resnet_{j}")(torch.cat([h, skips.pop()], dim=1), temb)
                if cfg.cross_attn_up[i]:
                    h = getattr(self, f"up_{i}_attn_{j}")(h, context)
            if i < len(ch) - 1:
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(F.silu(self.conv_norm_out(h))).permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class SDXLConfig:
    text: TextConfig = TextConfig()
    text_2: TextConfig = TextConfig(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
                                    num_attention_heads=20, hidden_act="gelu", projection_dim=1280)
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig(scaling_factor=0.13025)
    solver: dpm.DPMSolverConfig = dpm.DPMSolverConfig()


class RefSDXL:
    """The four models on one device, weights as the caller sets them;
    batches run `chunk` lanes at a time, so the fp32 attention fits."""

    def __init__(self, config: SDXLConfig, device: torch.device | str, chunk: int = 1):
        self.config, self.device, self.chunk = config, torch.device(device), chunk
        with torch.device(self.device):
            self.text_encoder = TextEncoder(config.text)
            self.text_encoder_2 = TextEncoder(config.text_2)
            self.unet = UNet2DCondition(config.unet)
            self.vae = AutoencoderKL(config.vae)
        for m in self.models().values():
            m.eval().requires_grad_(False)
        self.schedule = dpm.make_schedule(config.solver)

    def models(self) -> dict[str, nn.Module]:
        return {"text_encoder": self.text_encoder, "text_encoder_2": self.text_encoder_2, "unet": self.unet,
                "vae": self.vae}

    def image_size(self) -> int:
        return self.config.unet.sample_size * 2 ** (len(self.config.vae.block_out_channels) - 1)

    def encode(self, ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (context [B, S, C1 + C2], pooled [B, P]); zeros for an empty prompt."""
        ids = ids.to(self.device).long()
        a, b = self.text_encoder(ids), self.text_encoder_2(ids)
        context, pooled = torch.cat([a["penultimate"], b["penultimate"]], dim=-1), b["text_embeds"]
        empty = (ids[:, 1] == self.config.text.eos_token_id)[:, None]
        return torch.where(empty[:, :, None], 0.0, context), torch.where(empty, 0.0, pooled)

    def build_context(self, cond_ids, uncond_ids, n: int):
        """-> (context [2n, S, C], pooled [2n, P], time ids [2n, 6]) in CFG
        order [uncond; cond]."""
        cond, cond_pooled = self.encode(cond_ids)
        uncond, uncond_pooled = self.encode(uncond_ids)
        b = lambda x: x.expand(n, *x.shape[1:])
        s = self.image_size()
        time_ids = torch.tensor([[s, s, 0, 0, s, s]], dtype=torch.float32, device=self.device).expand(2 * n, 6)
        return (torch.cat([b(uncond), b(cond)]), torch.cat([b(uncond_pooled), b(cond_pooled)]), time_ids)

    @torch.no_grad()
    def generate(self, noises, cond_ids, uncond_ids, num_steps: int, guidance_scale: float, *,
                 unet_lora: Optional[Mapping] = None) -> torch.Tensor:
        """encode -> denoise -> decode, `chunk` lanes at a time -> images
        [N, H, W, 3] in [-1, 1], fp32."""
        noises = noises.to(self.device).float()
        weights = lora_lib.apply_lora(self.unet, unet_lora) if unet_lora is not None else {}
        bundle = dpm.make_step_bundle(self.config.solver, self.schedule, num_steps)
        out = []
        for z in noises.split(self.chunk):
            context, pooled, time_ids = self.build_context(cond_ids, uncond_ids, z.shape[0])
            eps_fn = lambda lat2, t: functional_call(self.unet, weights, (lat2, t, context, pooled, time_ids))
            lat = dpm.denoise(eps_fn, z, bundle, guidance_scale=guidance_scale)
            out.append(self.vae.decode(lat / self.config.vae.scaling_factor).float().clamp(-1.0, 1.0))
        return torch.cat(out)
