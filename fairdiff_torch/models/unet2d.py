"""SD-1.5 conditional U-Net (counterpart of fairdiff/models/unet2d.py).

The public call takes and returns the JAX package's NHWC latents; inside,
convolutions run NCHW and each spatial transformer works on [B, H*W, C]
tokens. Submodule names follow the JAX parameter tree (`down_0_resnet_0`,
`mid_attn_0`, `up_3_attn_2`, ...) so the weight carry-over is by path.
Self-attention over at least FLASH_MIN_KV tokens (the 1024- and 4096-token
latents at 512 px; the 576-token ones of the 1280-channel blocks, head dim
160, at 768 px) runs the flash-attention kernels on CUDA (`use_flash`, set
here only, as the JAX package sets it for the UNet), and every feed-forward
runs the fused GEGLU kernels on CUDA; both through autograd Functions where
a gradient is wanted; `flash_bwd` ("split": K2 + K3, "merged": K6,
"recompute": the plain attention's autograd) picks the flash backward. `remat=True` recomputes each resnet and transformer block in
the backward instead of keeping its activations (`torch.utils.checkpoint`, the
counterpart of `nn.remat` in the JAX module). A caller that runs the UNet
under `torch.func.functional_call` with replaced weights (merged LoRA) passes
the same mapping as `weights`: the recompute runs after `functional_call` has
put the module's own weights back, so each checkpointed block swaps its slice
of the mapping in again for it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from fairdiff_torch.models.layers import dot_product_attention, expand_padding_mask
from fairdiff_torch.ops.flash_attention import check_flash_bwd
from fairdiff_torch.ops.geglu import geglu


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8  # diffusers quirk: this is the head *count*
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    cross_attn_down: tuple[bool, ...] = (True, True, True, False)
    cross_attn_up: tuple[bool, ...] = (False, True, True, True)

    @classmethod
    def sd15(cls) -> "UNetConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "UNetConfig":
        """CPU-testable miniature with the same topology."""
        return cls(
            sample_size=8,
            block_out_channels=(32, 64, 64, 64),
            cross_attention_dim=32,
            attention_head_dim=2,
            norm_num_groups=8,
        )


def timestep_embedding(
    timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True, freq_shift: float = 0.0
) -> torch.Tensor:
    """Sinusoidal embedding [B, dim] in fp32 (diffusers `get_timestep_embedding`)."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(emb)))


class ResnetBlock2D(nn.Module):
    """NCHW resnet block; `temb_dim=None` builds it without the time
    projection (the VAE's blocks)."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 eps: float = 1e-5, temb_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    """diffusers-style attention (to_q/to_k/to_v biasless, to_out biased)."""

    def __init__(self, query_dim: int, heads: int, context_dim: Optional[int] = None,
                 flash_bwd: str = "split"):
        super().__init__()
        context_dim = context_dim or query_dim
        self.heads = heads
        self.flash_bwd = check_flash_bwd(flash_bwd)
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(context_dim, query_dim, bias=False)
        self.to_v = nn.Linear(context_dim, query_dim, bias=False)
        self.to_out = nn.Linear(query_dim, query_dim)

    def forward(
        self,
        x: torch.Tensor,  # [B, S, C]
        context: Optional[torch.Tensor] = None,  # [B, T, Cc]
        context_mask: Optional[torch.Tensor] = None,  # [B, T] {0,1} key mask
    ) -> torch.Tensor:
        context = x if context is None else context
        B, S, C = x.shape
        T = context.shape[1]
        q = self.to_q(x).reshape(B, S, self.heads, -1)
        k = self.to_k(context).reshape(B, T, self.heads, -1)
        v = self.to_v(context).reshape(B, T, self.heads, -1)
        # masking pad keys makes the static-77 context equal to the
        # reference's compact-length cross-attention
        bias = None if context_mask is None else expand_padding_mask(context_mask)
        out = dot_product_attention(q, k, v, bias, self.flash_bwd, use_flash=True).reshape(B, S, C)
        return self.to_out(out)


class FeedForwardGEGLU(nn.Module):
    """proj (d -> 8d) -> h * gelu(gate) -> out (4d -> d). One `proj` Linear
    whichever path runs: the kernel reads its weight and bias directly."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.proj = nn.Linear(dim, dim * mult * 2)
        self.out = nn.Linear(dim * mult, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(geglu(x, self.proj.weight, self.proj.bias))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int, flash_bwd: str = "split"):
        super().__init__()
        # eps 1e-5: torch's LayerNorm default, as diffusers uses
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads, flash_bwd=flash_bwd)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, heads, context_dim, flash_bwd)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForwardGEGLU(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context, context_mask)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> 1x1 proj -> block -> 1x1 proj + residual."""

    def __init__(self, channels: int, heads: int, context_dim: int, groups: int = 32,
                 flash_bwd: str = "split"):
        super().__init__()
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks_0 = BasicTransformerBlock(channels, heads, context_dim, flash_bwd)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.transformer_blocks_0(h, context, context_mask)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return self.proj_out(h) + x


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNet2DCondition(nn.Module):
    """The SD U-Net epsilon-predictor.

    forward(latents [B,H,W,4] NHWC, timesteps [B] or scalar,
            context [B,T,768], key mask [B,T] or None) -> eps [B,H,W,4] NHWC
    """

    def __init__(self, config: UNetConfig = UNetConfig.sd15(), remat: bool = False,
                 flash_bwd: str = "split"):
        super().__init__()
        self.config = cfg = config
        self.remat = remat
        self.flash_bwd = flash_bwd  # checked by each CrossAttention
        ch = cfg.block_out_channels
        heads, ctx, groups, eps = (
            cfg.attention_head_dim, cfg.cross_attention_dim, cfg.norm_num_groups, cfg.norm_eps,
        )
        temb_dim = ch[0] * 4
        self.time_embedding = TimestepEmbedding(ch[0], temb_dim)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)

        def add(name: str, module: nn.Module) -> None:
            self.add_module(name, module)

        skip_ch = [ch[0]]
        cur = ch[0]
        for i, out_ch in enumerate(ch):
            for j in range(cfg.layers_per_block):
                add(f"down_{i}_resnet_{j}", ResnetBlock2D(cur, out_ch, groups, eps, temb_dim))
                cur = out_ch
                if cfg.cross_attn_down[i]:
                    add(f"down_{i}_attn_{j}", Transformer2D(cur, heads, ctx, groups, flash_bwd))
                skip_ch.append(cur)
            if i < len(ch) - 1:
                add(f"down_{i}_downsample", Downsample2D(cur))
                skip_ch.append(cur)

        add("mid_resnet_0", ResnetBlock2D(cur, cur, groups, eps, temb_dim))
        add("mid_attn_0", Transformer2D(cur, heads, ctx, groups, flash_bwd))
        add("mid_resnet_1", ResnetBlock2D(cur, cur, groups, eps, temb_dim))

        for i, out_ch in enumerate(reversed(ch)):
            for j in range(cfg.layers_per_block + 1):
                add(f"up_{i}_resnet_{j}",
                    ResnetBlock2D(cur + skip_ch.pop(), out_ch, groups, eps, temb_dim))
                cur = out_ch
                if cfg.cross_attn_up[i]:
                    add(f"up_{i}_attn_{j}", Transformer2D(cur, heads, ctx, groups, flash_bwd))
            if i < len(ch) - 1:
                add(f"up_{i}_upsample", Upsample2D(cur))

        self.conv_norm_out = nn.GroupNorm(groups, cur, eps=eps)
        self.conv_out = nn.Conv2d(cur, cfg.out_channels, 3, padding=1)

    def forward(
        self,
        sample: torch.Tensor,
        timesteps: torch.Tensor | int | float,
        encoder_hidden_states: torch.Tensor,
        encoder_attention_mask: Optional[torch.Tensor] = None,
        weights: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        cfg = self.config
        ch = cfg.block_out_channels
        dtype = self.conv_in.weight.dtype
        B = sample.shape[0]
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(B)
        t_emb = timestep_embedding(timesteps, ch[0], cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(t_emb.to(dtype))

        context = encoder_hidden_states.to(dtype)
        mask = encoder_attention_mask
        remat = self.remat and torch.is_grad_enabled()
        block_weights: dict[str, dict[str, torch.Tensor]] = {}
        for key, w in (weights or {}).items():
            name, _, rest = key.partition(".")
            block_weights.setdefault(name, {})[rest] = w

        def block(name: str):
            module = getattr(self, name)
            if remat and isinstance(module, (ResnetBlock2D, Transformer2D)):
                own = block_weights.get(name)
                if own:
                    return lambda *args: checkpoint(functional_call, module, own, args, use_reentrant=False)
                return lambda *args: checkpoint(module, *args, use_reentrant=False)
            return module

        h = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))
        skips = [h]
        for i in range(len(ch)):
            for j in range(cfg.layers_per_block):
                h = block(f"down_{i}_resnet_{j}")(h, temb)
                if cfg.cross_attn_down[i]:
                    h = block(f"down_{i}_attn_{j}")(h, context, mask)
                skips.append(h)
            if i < len(ch) - 1:
                h = block(f"down_{i}_downsample")(h)
                skips.append(h)

        h = block("mid_resnet_0")(h, temb)
        h = block("mid_attn_0")(h, context, mask)
        h = block("mid_resnet_1")(h, temb)

        for i in range(len(ch)):
            for j in range(cfg.layers_per_block + 1):
                h = block(f"up_{i}_resnet_{j}")(torch.cat([h, skips.pop()], dim=1), temb)
                if cfg.cross_attn_up[i]:
                    h = block(f"up_{i}_attn_{j}")(h, context, mask)
            if i < len(ch) - 1:
                h = block(f"up_{i}_upsample")(h)

        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1)
