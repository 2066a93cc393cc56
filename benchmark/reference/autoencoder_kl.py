"""SD-1.5 VAE (a frozen copy of fairdiff_torch/models/autoencoder_kl.py for the
benchmark's reference).

Public calls take and return NHWC like the JAX package; convolutions run
NCHW inside. The mid-block attention is plain PyTorch, as the JAX package's
is plain einsum: no kernel runs in the VAE.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import lowp
from benchmark.reference.unet2d import ResnetBlock2D, Upsample2D


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    @classmethod
    def sd15(cls) -> "VAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_out_channels=(16, 16, 32, 32), norm_num_groups=8)


class VAEAttention(nn.Module):
    """Single-head full self-attention over spatial positions (VAE mid)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = (lowp.round_(f(h)) for f in (self.to_q, self.to_k, self.to_v))
        logits = torch.matmul(q, k.transpose(1, 2)).float() * C**-0.5
        attn = lowp.round_(torch.softmax(logits, dim=-1).to(h.dtype))
        h = self.to_out(torch.matmul(attn, v))
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        ch, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        cur = ch[0]
        for i, out_ch in enumerate(ch):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_resnet_{j}", ResnetBlock2D(cur, out_ch, g, 1e-5))
                cur = out_ch
            if i < len(ch) - 1:
                self.add_module(f"down_{i}_downsample", nn.Conv2d(cur, cur, 3, stride=2))
        self.mid_resnet_0 = ResnetBlock2D(cur, cur, g, 1e-5)
        self.mid_attn = VAEAttention(cur, g)
        self.mid_resnet_1 = ResnetBlock2D(cur, cur, g, 1e-5)
        self.conv_norm_out = nn.GroupNorm(g, cur, eps=1e-6)
        self.conv_out = nn.Conv2d(cur, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        n = len(cfg.block_out_channels)
        h = self.conv_in(x)
        for i in range(n):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_resnet_{j}")(h)
            if i < n - 1:
                # diffusers VAE downsample: asymmetric (0,1,0,1) pad, stride 2
                h = getattr(self, f"down_{i}_downsample")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h)))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        ch, g = tuple(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch[0], 3, padding=1)
        self.mid_resnet_0 = ResnetBlock2D(ch[0], ch[0], g, 1e-5)
        self.mid_attn = VAEAttention(ch[0], g)
        self.mid_resnet_1 = ResnetBlock2D(ch[0], ch[0], g, 1e-5)
        cur = ch[0]
        for i, out_ch in enumerate(ch):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_resnet_{j}", ResnetBlock2D(cur, out_ch, g, 1e-5))
                cur = out_ch
            if i < len(ch) - 1:
                self.add_module(f"up_{i}_upsample", Upsample2D(cur))
        self.conv_norm_out = nn.GroupNorm(g, cur, eps=1e-6)
        self.conv_out = nn.Conv2d(cur, cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        n = len(cfg.block_out_channels)
        h = self.conv_in(z)
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h)))
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{i}_resnet_{j}")(h)
            if i < n - 1:
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig.sd15()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def _dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """images [B,H,W,3] -> (mean, logvar) of the latent posterior, NHWC."""
        moments = self.quant_conv(self.encoder(x.to(self._dtype()).permute(0, 3, 1, 2)))
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latents [B,h,w,4] (already divided by scaling_factor) -> images
        [B,H,W,3]; the caller clamps to [-1, 1]."""
        out = self.decoder(self.post_quant_conv(z.to(self._dtype()).permute(0, 3, 1, 2)))
        return out.permute(0, 2, 3, 1)
