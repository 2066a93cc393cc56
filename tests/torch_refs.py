"""Minimal torch reference blocks mirroring diffusers 0.19.3 semantics.

The reference consumes `UNet2DConditionModel` / `AutoencoderKL` from
diffusers 0.19.3 (exp-1-debias-gender/1-main-debias.py:722-794). diffusers
is not installed in this environment, so these hand-written torch modules
reproduce the exact forward math and — crucially — the state_dict() KEY
LAYOUT of the originals (down_blocks.{i}.resnets.{j}.conv1, ff.net.0.proj,
attn1.to_out.0, ...), so fairdiff.io.sd_loader can convert them unchanged.
They exist only to golden-test the Flax modules + converters at activation
level (tests/test_unet_vae.py); nothing imports them at runtime.

Semantics encoded (diffusers 0.19.3, SD-1.5 configuration):
  - ResnetBlock2D: GN(eps 1e-5)/SiLU/3x3 conv, temb add after conv1,
    1x1 conv_shortcut when channels change, output_scale_factor 1
  - BasicTransformerBlock: pre-LN (eps 1e-5), self-attn, cross-attn,
    GEGLU feed-forward (hidden * gelu(gate), exact erf gelu)
  - Attention: biasless to_q/k/v, head split (B,S,H,D)->(B*H,S,D),
    scale (dim/heads)^-0.5, biased to_out
  - Transformer2D (use_linear_projection=False): GN(eps 1e-6), 1x1
    proj_in, NCHW->(B,HW,C), blocks, proj_out, residual
  - Down/Up blocks: skip appended AFTER the attention; up concat order
    cat([hidden, skip], channel); downsample conv stride 2 pad 1;
    upsample nearest x2 + 3x3 conv
  - VAE: encoder downsample with asymmetric (0,1,0,1) pad; mid
    single-head attention (scale C^-0.5) with modern to_q/to_out naming
  - timestep embedding: flip_sin_to_cos=True, freq_shift=0

SDXL base 1.0 (diffusers' `unet/config.json` options, read from the config
where it has them, so the SD-1.5 configuration builds what it built):
  - attention_head_dim a head count per level, transformer_layers_per_block
    a depth per level (the mid block takes the last, the up blocks the
    reversed lists), `transformer_blocks.{k}` for k below the depth
  - use_linear_projection: GN, NCHW->(B,HW,C), then a Linear proj_in; a
    Linear proj_out before (B,HW,C)->NCHW
  - addition_embed_type "text_time": add_time_proj (the sinusoids of each
    of the six time ids, addition_time_embed_dim wide, flattened), then
    add_embedding(cat[text_embeds, time_embeds]) added to the time embedding
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F


def timestep_embedding_t(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32)
    exponent = exponent / half  # freq_shift 0
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)  # flipped


class TTimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class TResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_dim: int | None,
                 groups: int, eps: float = 1e-5):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)
        else:
            self.conv_shortcut = None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class TAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int, context_dim: int | None):
        super().__init__()
        ctx = query_dim if context_dim is None else context_dim
        self.heads = heads
        self.scale = (query_dim // heads) ** -0.5
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(ctx, query_dim, bias=False)
        self.to_v = nn.Linear(ctx, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])

    def forward(self, x, context=None):
        context = x if context is None else context
        B, S, C = x.shape
        H, D = self.heads, C // self.heads
        q = self.to_q(x).view(B, S, H, D).permute(0, 2, 1, 3)
        k = self.to_k(context).view(B, -1, H, D).permute(0, 2, 1, 3)
        v = self.to_v(context).view(B, -1, H, D).permute(0, 2, 1, 3)
        attn = torch.softmax(q @ k.transpose(-1, -2) * self.scale, dim=-1)
        out = (attn @ v).permute(0, 2, 1, 3).reshape(B, S, C)
        return self.to_out[0](out)


class TGEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class TBasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = TAttention(dim, heads, None)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = TAttention(dim, heads, context_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = nn.Module()
        self.ff.net = nn.ModuleList(
            [TGEGLU(dim, dim * 4), nn.Identity(), nn.Linear(dim * 4, dim)]
        )

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff.net[2](self.ff.net[0](self.norm3(x)))


class TTransformer2D(nn.Module):
    def __init__(self, channels: int, heads: int, context_dim: int, groups: int,
                 depth: int = 1, linear: bool = False):
        super().__init__()
        self.linear = linear
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        proj = nn.Linear if linear else (lambda a, b: nn.Conv2d(a, b, 1))
        self.proj_in = proj(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            [TBasicTransformerBlock(channels, heads, context_dim) for _ in range(depth)]
        )
        self.proj_out = proj(channels, channels)

    def forward(self, x, context):
        B, C, H, W = x.shape
        res = x
        h = self.norm(x)
        if self.linear:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(B, H * W, C))
        else:
            h = self.proj_in(h).permute(0, 2, 3, 1).reshape(B, H * W, C)
        for block in self.transformer_blocks:
            h = block(h, context)
        if self.linear:
            return self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2) + res
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return self.proj_out(h) + res


class TDownsample(nn.Module):
    def __init__(self, ch: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = nn.Conv2d(ch, ch, 3, stride=2,
                              padding=0 if asymmetric_pad else 1)

    def forward(self, x):
        if self.asymmetric_pad:  # diffusers VAE Downsample2D
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class TUpsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class TUNet(nn.Module):
    """diffusers UNet2DConditionModel at the fairdiff UNetConfig."""

    def __init__(self, cfg):
        super().__init__()
        ch = cfg.block_out_channels
        temb_dim = ch[0] * 4
        g = cfg.norm_num_groups
        h_, d_ = cfg.attention_head_dim, getattr(cfg, "transformer_layers_per_block", 1)
        linear = getattr(cfg, "use_linear_projection", False)
        self.cfg = cfg

        def attn(level, channels):
            return TTransformer2D(channels, h_ if isinstance(h_, int) else h_[level], cfg.cross_attention_dim, g,
                                  d_ if isinstance(d_, int) else d_[level], linear)

        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TTimestepEmbedding(ch[0], temb_dim)
        self.text_time = getattr(cfg, "addition_embed_type", None) == "text_time"
        if self.text_time:
            self.add_embedding = TTimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb_dim)

        self.down_blocks = nn.ModuleList()
        in_ch = ch[0]
        for i, out_ch in enumerate(ch):
            block = nn.Module()
            block.resnets = nn.ModuleList()
            block.attentions = nn.ModuleList()
            for j in range(cfg.layers_per_block):
                block.resnets.append(
                    TResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, temb_dim, g)
                )
                if cfg.cross_attn_down[i]:
                    block.attentions.append(attn(i, out_ch))
            if i < len(ch) - 1:
                block.downsamplers = nn.ModuleList([TDownsample(out_ch)])
            self.down_blocks.append(block)
            in_ch = out_ch

        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [TResnetBlock2D(ch[-1], ch[-1], temb_dim, g) for _ in range(2)]
        )
        self.mid_block.attentions = nn.ModuleList([attn(len(ch) - 1, ch[-1])])

        # skip channel bookkeeping mirrors diffusers get_up_block wiring
        skip_chs = [ch[0]]
        for i, out_ch in enumerate(ch):
            skip_chs += [out_ch] * cfg.layers_per_block
            if i < len(ch) - 1:
                skip_chs.append(out_ch)
        self.up_blocks = nn.ModuleList()
        rev = tuple(reversed(ch))
        prev = ch[-1]
        for i, out_ch in enumerate(rev):
            block = nn.Module()
            block.resnets = nn.ModuleList()
            block.attentions = nn.ModuleList()
            for j in range(cfg.layers_per_block + 1):
                skip = skip_chs.pop()
                block.resnets.append(
                    TResnetBlock2D(prev + skip, out_ch, temb_dim, g)
                )
                prev = out_ch
                if cfg.cross_attn_up[i]:
                    block.attentions.append(attn(len(ch) - 1 - i, out_ch))
            if i < len(rev) - 1:
                block.upsamplers = nn.ModuleList([TUpsample(out_ch)])
            self.up_blocks.append(block)

        self.conv_norm_out = nn.GroupNorm(g, ch[0], eps=cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, context, added_cond_kwargs=None):
        cfg = self.cfg
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = self.time_embedding(
            timestep_embedding_t(timesteps, cfg.block_out_channels[0])
        )
        if self.text_time:
            text_embeds = added_cond_kwargs["text_embeds"]
            time_embeds = timestep_embedding_t(
                added_cond_kwargs["time_ids"].flatten(), cfg.addition_time_embed_dim
            ).reshape(text_embeds.shape[0], -1)
            temb = temb + self.add_embedding(torch.cat([text_embeds, time_embeds], dim=-1))
        h = self.conv_in(sample)
        skips = [h]
        for i, block in enumerate(self.down_blocks):
            for j, resnet in enumerate(block.resnets):
                h = resnet(h, temb)
                if cfg.cross_attn_down[i]:
                    h = block.attentions[j](h, context)
                skips.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
                skips.append(h)
        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, context)
        h = self.mid_block.resnets[1](h, temb)
        for i, block in enumerate(self.up_blocks):
            for j, resnet in enumerate(block.resnets):
                h = torch.cat([h, skips.pop()], dim=1)
                h = resnet(h, temb)
                if cfg.cross_attn_up[i]:
                    h = block.attentions[j](h, context)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class TVAEAttention(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).view(B, C, H * W).transpose(1, 2)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        attn = torch.softmax(q @ k.transpose(-1, -2) * C ** -0.5, dim=-1)
        h = self.to_out[0](attn @ v)
        return x + h.transpose(1, 2).view(B, C, H, W)


class TVAEEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        ch = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        in_ch = ch[0]
        for i, out_ch in enumerate(ch):
            block = nn.Module()
            block.resnets = nn.ModuleList(
                [TResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, None, g)
                 for j in range(cfg.layers_per_block)]
            )
            if i < len(ch) - 1:
                block.downsamplers = nn.ModuleList(
                    [TDownsample(out_ch, asymmetric_pad=True)]
                )
            self.down_blocks.append(block)
            in_ch = out_ch
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [TResnetBlock2D(ch[-1], ch[-1], None, g) for _ in range(2)]
        )
        self.mid_block.attentions = nn.ModuleList([TVAEAttention(ch[-1], g)])
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class TVAEDecoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        ch = tuple(reversed(cfg.block_out_channels))
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch[0], 3, padding=1)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [TResnetBlock2D(ch[0], ch[0], None, g) for _ in range(2)]
        )
        self.mid_block.attentions = nn.ModuleList([TVAEAttention(ch[0], g)])
        self.up_blocks = nn.ModuleList()
        in_ch = ch[0]
        for i, out_ch in enumerate(ch):
            block = nn.Module()
            block.resnets = nn.ModuleList(
                [TResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, None, g)
                 for j in range(cfg.layers_per_block + 1)]
            )
            if i < len(ch) - 1:
                block.upsamplers = nn.ModuleList([TUpsample(out_ch)])
            self.up_blocks.append(block)
            in_ch = out_ch
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class TVAE(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.encoder = TVAEEncoder(cfg)
        self.decoder = TVAEDecoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def encode_moments(self, x):
        return self.quant_conv(self.encoder(x))

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))
