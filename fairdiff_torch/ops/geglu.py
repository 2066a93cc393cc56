"""Fused GEGLU forward (kernel K4) and its plain PyTorch version.

Counterpart of fairdiff/ops/geglu.py `_geglu_forward`. The CUDA kernel is
`csrc/geglu.cu`; it reads the feed-forward's own `proj` Linear weight
[2I, d] (torch layout) and bias [2I], so the module keeps one parameter
tree whichever path runs. On a CPU tensor the wrapper runs `geglu_plain`;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from fairdiff_torch.kernels import build

# kernel launches, counted where the kernel is launched
launches = 0

_ENTRY = {torch.bfloat16: "fd_geglu_fwd_bf16", torch.float32: "fd_geglu_fwd_f32"}


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    fn = getattr(build.load("geglu"), _ENTRY[dtype])
    p = ctypes.c_void_p
    i = ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def geglu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Same maths without the kernel: the [.., 2I] projection in the input
    type, then h * gelu(gate) in fp32 (fairdiff `_xla_geglu`)."""
    proj = F.linear(x, w, b).float()
    h, gate = proj.chunk(2, dim=-1)
    return (h * F.gelu(gate, approximate="none")).to(x.dtype)


def geglu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y[..., I] = h * gelu(gate) with [h | gate] = x[..., d] @ w[2I, d]^T + b."""
    global launches
    d = x.shape[-1]
    if w.dim() != 2 or w.shape[1] != d or w.shape[0] % 2 or b.shape != (w.shape[0],):
        raise ValueError(f"want w [2I, {d}] and b [2I]; got {tuple(w.shape)}, {tuple(b.shape)}")
    if not (x.dtype == w.dtype == b.dtype):
        raise TypeError(f"mixed dtypes {x.dtype}, {w.dtype}, {b.dtype}")
    if not (x.device == w.device == b.device):
        raise ValueError("x, w and b must be on one device")
    if x.device.type == "cpu":
        return geglu_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"geglu runs on cuda or cpu, not {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"the kernel takes bfloat16 or float32, not {x.dtype}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("the kernel reads contiguous x, w and b")
    if x.dtype == torch.bfloat16 and (d % 8 or x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("the bf16 kernel reads 16-byte rows: d % 8 == 0, x and w 16-byte aligned")
    inner = w.shape[0] // 2
    m = x.numel() // d
    y = torch.empty(*x.shape[:-1], inner, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel(x.dtype)(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), m, d, inner, stream
        )
    if rc != 0:
        raise RuntimeError(f"geglu kernel launch failed: CUDA error {rc}")
    launches += 1
    return y
