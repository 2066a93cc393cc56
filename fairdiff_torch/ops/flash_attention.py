"""Flash-attention forward (kernel K1) and its plain PyTorch version.

Counterpart of fairdiff/ops/flash_attention.py `_flash_forward` (no lse).
The CUDA kernel is `csrc/flash_attention.cu`; it reads q/k/v in the JAX
package's [B, S, H, D] layout straight from memory, so the wrapper makes no
relayout copy. On a CPU tensor the wrapper runs `flash_attention_plain`;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fairdiff_torch.kernels import build

# keys from which self-attention takes the kernel (fairdiff/models/layers.py
# FLASH_MIN_KV): the UNet's 1024- and 4096-token latents do, the 77-token
# cross-attention and the 256/64-token latents do not
FLASH_MIN_KV = 512

# kernel launches, counted where the kernel is launched
launches = 0

_ENTRY = {torch.bfloat16: "fd_flash_fwd_bf16", torch.float32: "fd_flash_fwd_f32"}


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    fn = getattr(build.load("flash_attention"), _ENTRY[dtype])
    p = ctypes.c_void_p
    i = ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Same maths without the kernel: fp32 logits and softmax, probabilities
    rounded to the input type before P.V (fairdiff `_xla_attention`)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,S,H,D], k/v [B,T,H,D]; got {q.shape}, {k.shape}, {v.shape}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[2] != H or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree on B, H or D")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal o = softmax(D**-0.5 q k^T) v; q [B,S,H,D], k/v [B,T,H,D]."""
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dtype not in _ENTRY:
        raise TypeError(f"the kernel takes bfloat16 or float32, not {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel reads contiguous [B,S,H,D] tensors")
    B, S, H, D = q.shape
    if D > 128:
        raise ValueError(f"the kernel takes head dims up to 128, not {D}")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, S, k.shape[1], H, D, D**-0.5, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {rc}")
    launches += 1
    return o
