"""Fused GroupNorm (+ SiLU): the forward kernel K7, its plain PyTorch
version and the autograd Function around them.

Counterpart of fairdiff/ops/group_norm.py: `_gn_forward` (K7, Pallas body
`_gn_silu_kernel`), `_xla_group_norm` (the plain version) and the custom_vjp
`fused_group_norm_silu` (`_gn_fwd` / `_gn_bwd`). The layout is the JAX
package's: x [B, ..., C] channel-last, scale and bias [C] fp32, the output in
x's type. The statistics are the kernel's formula, fp32 sum and sum of
squares per (sample, group) with var = max(ss/n - mean^2, 0), in the plain
version too, so the two differ only in summation order. The backward is the
plain version's autograd, recomputed, as the JAX `_gn_bwd` is an
XLA-recompute VJP: the TPU kernel has no backward kernel, and neither does
the port.

K7 (`csrc/group_norm.cu`) is one launch: a thread-block cluster per
sample, each CTA a slice of the sample's rows, the group statistics summed
across the cluster in distributed shared memory. It takes every shape with
C % groups == 0: none of the TPU kernel's applicability rules (the 3 MB
block cap, rows >= 1024) carries over. On a CPU tensor the wrappers run the
plain version; on a CUDA tensor they launch K7 or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from fairdiff_torch.kernels import build
from fairdiff_torch.ops import counting

# K7 launches, counted where the kernel is launched (not under a CUDA
# graph's capture: `fairdiff_torch.ops`)
launches = 0

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
# CTAs a sample's cluster: 8 measured fastest at batch 8 on an H100 (0.095-
# 0.098 ms at 8 x 4096 x 960, against 0.108 at 16, 0.153 at 4 and 0.277 at 2;
# `chip_smoke.phase_kernels_gn()` with MAX_CLUSTER set to each); the kernel
# takes up to 16, the non-portable cluster size
MAX_CLUSTER = 8


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    """`fd_group_norm_<dtype>`: x, scale, bias, out; B, rows, C, groups,
    rows a CTA, CTAs a cluster, silu; eps; stream."""
    fn = getattr(build.load("group_norm"), f"fd_group_norm_{_DTYPES[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def row_chunks(batch: int, rows: int) -> tuple[int, int]:
    """(rows a CTA, CTAs a sample): the kernel's cut of each sample's rows
    into the slices of one cluster of at most MAX_CLUSTER CTAs; every CTA
    gets at least one row."""
    per = -(-rows // min(rows, MAX_CLUSTER))
    return per, -(-rows // per)


def group_norm_silu_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
    apply_silu: bool,
) -> torch.Tensor:
    """K7 without the kernel: fp32 sum and sum of squares per (sample,
    group), var = max(ss/n - mean^2, 0), y = x * w + b with w = scale * inv
    and b = bias - mean * w per channel, SiLU where asked, in x's type."""
    B, C = x.shape[0], x.shape[-1]
    xf = x.float().reshape(B, -1, groups, C // groups)
    n = xf.shape[1] * xf.shape[3]
    mean = xf.sum(dim=(1, 3)) / n  # [B, G]
    var = ((xf * xf).sum(dim=(1, 3)) / n - mean * mean).clamp_min(0.0)
    w = scale.float().reshape(groups, -1) * torch.rsqrt(var + eps)[..., None]  # [B, G, C/G]
    b = bias.float().reshape(groups, -1) - mean[..., None] * w
    y = xf * w[:, None] + b[:, None]
    if apply_silu:
        y = F.silu(y)
    return y.reshape(x.shape).to(x.dtype)


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int) -> None:
    if x.dim() < 2 or x.shape[0] < 1 or x.numel() == 0:
        raise ValueError(f"want x [B, ..., C] with B, C >= 1; got {tuple(x.shape)}")
    C = x.shape[-1]
    if groups < 1 or C % groups:
        raise ValueError(f"{C} channels do not split into {groups} groups")
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"want scale and bias [{C}]; got {tuple(scale.shape)}, {tuple(bias.shape)}")
    if not (x.device == scale.device == bias.device):
        raise ValueError("x, scale and bias must be on one device")


def _needs_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _forward(x, scale, bias, groups: int, eps: float, apply_silu: bool) -> torch.Tensor:
    global launches
    _check(x, scale, bias, groups)
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, scale, bias, groups, eps, apply_silu)
    if x.device.type != "cuda":
        raise ValueError(f"group norm runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPES or scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"the kernel takes bf16 or fp32 x and fp32 scale/bias, not "
                        f"{x.dtype}, {scale.dtype}, {bias.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("the kernel reads contiguous x, scale and bias")
    if _needs_grad(x, scale, bias):
        raise RuntimeError(
            "the kernel's output has no grad_fn: call fused_group_norm_silu (or "
            "FusedGroupNormSiLU.apply) for a result that carries gradients"
        )
    B, C = x.shape[0], x.shape[-1]
    rows = x.numel() // (B * C)
    per, cluster = row_chunks(B, rows)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel(x.dtype)(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), B, rows, C, groups,
            per, cluster, int(apply_silu), eps, stream,
        )
    if rc != 0:
        raise RuntimeError(f"group norm kernel launch failed: CUDA error {rc}")
    if counting():
        launches += 1
    return out


class FusedGroupNormSiLU(torch.autograd.Function):
    """Counterpart of the JAX custom_vjp: forward through K7, backward by
    autograd through the plain version recomputed from x, scale and bias."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, apply_silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (groups, eps, apply_silu)
        return _forward(x, scale, bias, groups, eps, apply_silu)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = group_norm_silu_plain(*inputs, *ctx.args)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None, None)


def fused_group_norm_silu(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
    apply_silu: bool = True,
) -> torch.Tensor:
    """GroupNorm over the channel-last axis of x [B, ..., C], optionally
    fused with SiLU; fp32 statistics whatever x's type. Differentiable where
    a gradient is wanted (through `FusedGroupNormSiLU`)."""
    if _needs_grad(x, scale, bias):
        return FusedGroupNormSiLU.apply(x, scale, bias, groups, eps, apply_silu)
    return _forward(x, scale, bias, groups, eps, apply_silu)
