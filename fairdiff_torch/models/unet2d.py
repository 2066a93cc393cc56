"""SD-1.5 and SDXL conditional U-Nets (counterpart of fairdiff/models/unet2d.py,
which has SD-1.5 alone).

The public call takes and returns the JAX package's NHWC latents; inside,
convolutions run NCHW and each spatial transformer works on [B, H*W, C]
tokens. Submodule names follow the JAX parameter tree (`down_0_resnet_0`,
`mid_attn_0`, `up_3_attn_2`, ...) so the weight carry-over is by path.
SDXL's options (`UNetConfig.sdxl()`): head counts and transformer depths per
level (`transformer_blocks_0..N-1` in each `Transformer2D`), linear
`proj_in`/`proj_out` on the token rows, and the "text_time" added embedding
(the pooled text vector and six size ids, summed into the time embedding).
The attention asks for the flash-attention kernels (`use_flash`, set here
only, as the JAX package sets it for the UNet; `layers.attention_route`):
on CUDA, where no gradient is wanted, every attention runs K1, the
cross-attention with its key mask; where one is wanted, self-attention over
at least FLASH_MIN_KV tokens (the 1024- and 4096-token latents at 512 px;
the 576-token ones of the 1280-channel blocks, head dim 160, at 768 px)
runs the kernels through an autograd Function, and the rest the plain
attention. Every feed-forward runs the fused GEGLU kernels on CUDA, through
an autograd Function where a gradient is wanted; `flash_bwd` ("split": K2 +
K3, "merged": K6, "recompute": the plain attention's autograd) picks the
flash backward. `remat=True` recomputes each resnet and transformer block in
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

from fairdiff_torch.models.layers import dot_product_attention
from fairdiff_torch.ops.flash_attention import check_flash_bwd
from fairdiff_torch.ops.geglu import geglu
from fairdiff_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # diffusers quirk: this is the head *count*, one for every level or one a level
    attention_head_dim: int | tuple[int, ...] = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    cross_attn_down: tuple[bool, ...] = (True, True, True, False)
    cross_attn_up: tuple[bool, ...] = (False, True, True, True)
    # SDXL's options, fields of SDXLUNetConfig (SD-1.5's configuration has none)
    transformer_layers_per_block = 1
    use_linear_projection = False
    addition_embed_type = None

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

    @classmethod
    def sdxl(cls) -> "SDXLUNetConfig":
        """stabilityai/stable-diffusion-xl-base-1.0 `unet/config.json`."""
        return SDXLUNetConfig(
            sample_size=128,
            block_out_channels=(320, 640, 1280),
            cross_attention_dim=2048,
            attention_head_dim=(5, 10, 20),
            cross_attn_down=(False, True, True),
            cross_attn_up=(True, True, False),
            transformer_layers_per_block=(1, 2, 10),
            use_linear_projection=True,
            addition_embed_type="text_time",
            addition_time_embed_dim=256,
            projection_class_embeddings_input_dim=2816,
        )

    @classmethod
    def tiny_xl(cls) -> "SDXLUNetConfig":
        """CPU-testable miniature of SDXL's topology: three levels, none at
        the first, two layers deep at the last, linear projections, the
        text_time embedding (a pooled vector of 16 and six 8-wide ids)."""
        return SDXLUNetConfig(
            sample_size=8,
            block_out_channels=(32, 64, 64),
            cross_attention_dim=48,
            attention_head_dim=(2, 2, 4),
            norm_num_groups=8,
            cross_attn_down=(False, True, True),
            cross_attn_up=(True, True, False),
            transformer_layers_per_block=(1, 1, 2),
            use_linear_projection=True,
            addition_embed_type="text_time",
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=16 + 6 * 8,
        )

    def heads(self, level: int) -> int:
        h = self.attention_head_dim
        return h if isinstance(h, int) else h[level]

    def depth(self, level: int) -> int:
        d = self.transformer_layers_per_block
        return d if isinstance(d, int) else d[level]


@dataclasses.dataclass(frozen=True)
class SDXLUNetConfig(UNetConfig):
    """SDXL's UNet options besides SD-1.5's fields."""

    # transformer layers of each level's attention (the mid block takes the last)
    transformer_layers_per_block: int | tuple[int, ...] = 1
    use_linear_projection: bool = False  # Linear proj_in/proj_out on the token rows, not 1x1 convs
    # "text_time": add_embedding(pooled text vector ++ sinusoids of the six size ids)
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 0


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
        out = dot_product_attention(q, k, v, None, self.flash_bwd, use_flash=True,
                                    key_mask=context_mask).reshape(B, S, -1)
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
    """Spatial transformer: GN -> proj_in -> `depth` blocks
    (`transformer_blocks_0..`) -> proj_out + residual. The projections are
    1x1 convs (SD-1.5) or, with `linear`, Linears on the token rows
    (SDXL, diffusers' `use_linear_projection`). Span "transformer_stack",
    key the depth."""

    def __init__(self, channels: int, heads: int, context_dim: int, groups: int = 32,
                 flash_bwd: str = "split", depth: int = 1, linear: bool = False):
        super().__init__()
        self.depth, self.linear = depth, linear
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        proj = (lambda: nn.Linear(channels, channels)) if linear else (lambda: nn.Conv2d(channels, channels, 1))
        self.proj_in = proj()
        for k in range(depth):
            self.add_module(f"transformer_blocks_{k}", BasicTransformerBlock(channels, heads, context_dim, flash_bwd))
        self.proj_out = proj()

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        with span("transformer_stack", self.depth):
            B, C, H, W = x.shape
            h = self.norm(x)
            if not self.linear:
                h = self.proj_in(h)
            h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
            if self.linear:
                h = self.proj_in(h)
            for k in range(self.depth):
                h = getattr(self, f"transformer_blocks_{k}")(h, context, context_mask)
            if self.linear:
                h = self.proj_out(h)
            h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
            if not self.linear:
                h = self.proj_out(h)
            return h + x


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
            context [B,T,768], key mask [B,T] or None,
            added_cond {"text_embeds": [B,1280], "time_ids": [B,6]} with
            the "text_time" embedding) -> eps [B,H,W,4] NHWC
    """

    def __init__(self, config: UNetConfig = UNetConfig.sd15(), remat: bool = False,
                 flash_bwd: str = "split"):
        super().__init__()
        self.config = cfg = config
        self.remat = remat
        self.flash_bwd = flash_bwd  # checked by each CrossAttention
        ch = cfg.block_out_channels
        ctx, groups, eps = cfg.cross_attention_dim, cfg.norm_num_groups, cfg.norm_eps
        temb_dim = ch[0] * 4
        self.time_embedding = TimestepEmbedding(ch[0], temb_dim)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb_dim)
        elif cfg.addition_embed_type is not None:
            raise ValueError(f"addition_embed_type {cfg.addition_embed_type!r}: only 'text_time' is ported")
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)

        def add(name: str, module: nn.Module) -> None:
            self.add_module(name, module)

        def attn(level: int, channels: int) -> Transformer2D:
            return Transformer2D(channels, cfg.heads(level), ctx, groups, flash_bwd, cfg.depth(level),
                                 cfg.use_linear_projection)

        skip_ch = [ch[0]]
        cur = ch[0]
        for i, out_ch in enumerate(ch):
            for j in range(cfg.layers_per_block):
                add(f"down_{i}_resnet_{j}", ResnetBlock2D(cur, out_ch, groups, eps, temb_dim))
                cur = out_ch
                if cfg.cross_attn_down[i]:
                    add(f"down_{i}_attn_{j}", attn(i, cur))
                skip_ch.append(cur)
            if i < len(ch) - 1:
                add(f"down_{i}_downsample", Downsample2D(cur))
                skip_ch.append(cur)

        add("mid_resnet_0", ResnetBlock2D(cur, cur, groups, eps, temb_dim))
        add("mid_attn_0", attn(len(ch) - 1, cur))
        add("mid_resnet_1", ResnetBlock2D(cur, cur, groups, eps, temb_dim))

        for i, out_ch in enumerate(reversed(ch)):
            for j in range(cfg.layers_per_block + 1):
                add(f"up_{i}_resnet_{j}",
                    ResnetBlock2D(cur + skip_ch.pop(), out_ch, groups, eps, temb_dim))
                cur = out_ch
                if cfg.cross_attn_up[i]:
                    add(f"up_{i}_attn_{j}", attn(len(ch) - 1 - i, cur))
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
        added_cond: Optional[Mapping[str, torch.Tensor]] = None,
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
        if cfg.addition_embed_type == "text_time":
            if added_cond is None:
                raise ValueError("this UNet takes added_cond: the pooled text vector and the time ids")
            text_embeds, time_ids = added_cond["text_embeds"], added_cond["time_ids"]
            time_embeds = timestep_embedding(time_ids.flatten(), cfg.addition_time_embed_dim, cfg.flip_sin_to_cos,
                                             cfg.freq_shift).reshape(text_embeds.shape[0], -1)
            temb = temb + self.add_embedding(torch.cat([text_embeds.float(), time_embeds], dim=-1).to(dtype))

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
