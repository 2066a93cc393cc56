"""Flash attention: forward (kernel K1, with or without lse), backward
(kernels K2 dq and K3 dk/dv, or the merged K6), their plain PyTorch
versions and the autograd Function that joins them.

Counterpart of fairdiff/ops/flash_attention.py: `_flash_forward` (K1, and
with `with_lse=True` the forward of the custom_vjp), `_dq_pallas` (K2),
`_dkv_pallas` (K3), `_flash_backward_merged` (K6), `_flash_backward` and the
`custom_vjp` `flash_attention` (`_fa_fwd` / `_fa_bwd`). The JAX package picks
the merged backward with the environment variable FAIRDIFF_FLASH_BWD=merged,
and its recompute fallback with FAIRDIFF_FLASH_BWD=recompute, read at trace
time; here it is the explicit argument `flash_bwd="split" | "merged" |
"recompute"`. The recompute route saves only q, k and v (its forward is K1
without lse) and its backward differentiates the plain attention, which
holds the [S, T] scores, as the JAX route differentiates `_xla_attention`. K6 sums dq across key blocks with fp32
reduce-adds in no fixed order, so its dq differs from run to run in the
last bits. Every bf16 kernel runs its products on wgmma with tiles fed by
TMA: K1 and K2 are the query-block design (a block owns q rows and streams
the key tiles), K3 and K6 the key-block design (a block owns keys and
streams the q tiles).

The CUDA kernels are `csrc/flash_attention.cu`; they read q/k/v/dO in the
JAX package's [B, S, H, D] layout straight from memory, so no wrapper makes
a relayout copy. lse is [B, H, S] fp32 (the TPU kernel's lane-broadcast
[B*H, S_pad, 128] layout is a TPU tiling artefact).
delta = rowsum(dO * o) is plain PyTorch, as it is XLA outside the kernels
in the JAX package (`_bwd_operands`).

On a CPU tensor every wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. `flash_attention` is the entry point the
models call: where a gradient is wanted it goes through `FlashAttention`
(forward with lse, backward through K2 and K3 or K6), otherwise it runs the
lse-free forward. A CUDA tensor that needs a gradient never gets an output
without a `grad_fn`: the low-level forward wrappers raise instead.
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

# kernel launches, counted where each kernel is launched: K1 without lse
# (generation), K1 with lse (the forward of a gradient pass), K2, K3, K6
launches = 0
launches_lse = 0
launches_dq = 0
launches_dkv = 0
launches_merged = 0

# the kernels' largest head dim (SD-1.5's 1280-channel transformers: 160);
# K6 takes up to MERGED_MAX_D, and the merged route computes larger head dims
# with K3 then K2 (csrc/flash_attention.cu, above `namespace kv`)
MAX_D = 160
MERGED_MAX_D = 128

# the backward routes: K2 + K3, K6, or autograd through the plain attention
FLASH_BWD = ("split", "merged", "recompute")
# K6 sums dq in an fp32 buffer [B, H, S_pad, D], S_pad a multiple of its
# kernel's 64-row q tile, so that every tile's bulk add is one whole
# contiguous span
DQ_ROWS = 64

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


@functools.lru_cache(maxsize=None)
def _kernel(name: str, dtype: torch.dtype):
    """The C entry `fd_flash_<name>_<dtype>`; argtypes from its pointer count."""
    fn = getattr(build.load("flash_attention"), f"fd_flash_{name}_{_DTYPES[dtype]}")
    n_ptr = {"fwd": 4, "fwd_lse": 5, "dq": 7, "dkv": 8, "bwd_merged": 9}[name]
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, tensors: list[torch.Tensor], q: torch.Tensor, t_len: int) -> None:
    B, S, H, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel(name, q.dtype)(
            *[x.data_ptr() for x in tensors], B, S, t_len, H, D, D**-0.5, stream
        )
    if rc != 0:
        raise RuntimeError(f"flash attention {name} kernel launch failed: CUDA error {rc}")


# -- plain versions ------------------------------------------------------------


def _acc(x: torch.Tensor) -> torch.Tensor:
    """The accumulation type: fp32, or fp64 for fp64 inputs (references)."""
    return x if x.dtype == torch.float64 else x.float()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Same maths without the kernel: fp32 logits and softmax, probabilities
    rounded to the input type before P.V (fairdiff `_xla_attention`)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def flash_attention_lse_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 with lse, without the kernel: fp32 scores with the scale applied to
    them, p = exp(s - m) in fp32, the unnormalised p rounded to the input type
    before P.V, l summed from the fp32 p -> (o [B,S,H,D], lse [B,H,S] fp32)."""
    s = torch.einsum("bshd,bthd->bhst", _acc(q), _acc(k)) * q.shape[-1] ** -0.5
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhst,bthd->bshd", _acc(p.to(q.dtype)), _acc(v)) / l.transpose(1, 2)
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * o) in fp32, [B, H, S] (`_bwd_operands`)."""
    return torch.einsum("bshd,bshd->bhs", _acc(do), _acc(o)).contiguous()


def _bwd_plain(q, k, v, do, lse, delta, which):
    dt = q.dtype
    scale = q.shape[-1] ** -0.5
    p = torch.exp(torch.einsum("bshd,bthd->bhst", _acc(q), _acc(k)) * scale - lse[..., None])
    dp = torch.einsum("bshd,bthd->bhst", _acc(do), _acc(v))
    ds = _acc((p * (dp - delta[..., None])).to(dt))
    if which == "dq":
        return (torch.einsum("bhst,bthd->bshd", ds, _acc(k)) * scale).to(dt)
    dk = torch.einsum("bhst,bshd->bthd", ds, _acc(q)) * scale
    dv = torch.einsum("bhst,bshd->bthd", _acc(p.to(dt)), _acc(do))
    return dk.to(dt), dv.to(dt)


def flash_attention_dq_plain(q, k, v, do, lse, delta) -> torch.Tensor:
    """K2 without the kernel: p = exp(scale q k^T - lse) in fp32,
    ds = p * (dO v^T - delta) rounded to the input type, dq = scale * ds k
    with fp32 accumulation, rounded once."""
    return _bwd_plain(q, k, v, do, lse, delta, "dq")


def flash_attention_dkv_plain(q, k, v, do, lse, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 without the kernel: dv = round(p)^T dO, dk = scale * ds^T q, with
    p and ds as in `flash_attention_dq_plain`."""
    return _bwd_plain(q, k, v, do, lse, delta, "dkv")


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 and K3 without the kernels, at the TPU kernels' rounding points:
    p = exp(scale q k^T - lse) in fp32; p rounded to the input type before
    P^T.dO; ds = p * (dO v^T - delta) rounded before ds.k and ds^T.q; fp32
    accumulation, the scale applied to dq and dk at the end."""
    delta = attention_delta(o, do)
    return (flash_attention_dq_plain(q, k, v, do, lse, delta),
            *flash_attention_dkv_plain(q, k, v, do, lse, delta))


# -- kernel wrappers -------------------------------------------------------------


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


def _check_cuda(*xs: torch.Tensor) -> None:
    q = xs[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes bfloat16 or float32, not {q.dtype}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("the kernel reads contiguous [B,S,H,D] tensors")
    if q.shape[-1] > MAX_D:
        raise ValueError(f"the kernel takes head dims up to {MAX_D}, not {q.shape[-1]}")


def _needs_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, with_lse: bool):
    global launches, launches_lse
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v) if with_lse else (flash_attention_plain(q, k, v), None)
    _check_cuda(q, k, v)
    if _needs_grad(q, k, v):
        raise RuntimeError(
            "the kernel's output has no grad_fn: call flash_attention (or "
            "FlashAttention.apply) for a result that carries gradients"
        )
    B, S, H, _ = q.shape
    o = torch.empty_like(q)
    if not with_lse:
        _launch("fwd", [q, k, v, o], q, k.shape[1])
        launches += 1
        return o, None
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    _launch("fwd_lse", [q, k, v, o, lse], q, k.shape[1])
    launches_lse += 1
    return o, lse


def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 with lse: (o [B,S,H,D], lse [B,H,S] fp32). No gradient."""
    return _forward(q, k, v, with_lse=True)


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check(q, k, v)
    B, S, H, _ = q.shape
    if do.shape != q.shape or lse.shape != (B, H, S) or delta.shape != (B, H, S):
        raise ValueError(f"want dO {tuple(q.shape)}, lse and delta {(B, H, S)}")
    if q.device.type == "cpu":
        return
    _check_cuda(q, k, v, do, lse, delta)
    if do.dtype != q.dtype or lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError(f"want dO in {q.dtype}, lse and delta in float32")


def flash_attention_dq(q, k, v, do, lse, delta) -> torch.Tensor:
    """K2: dq [B,S,H,D] from the forward's lse [B,H,S] and delta =
    rowsum(dO * o) [B,H,S] (plain version on the CPU)."""
    global launches_dq
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_dq_plain(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _launch("dq", [q, k, v, do, lse, delta, dq], q, k.shape[1])
    launches_dq += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: (dk, dv) [B,T,H,D] (plain version on the CPU)."""
    global launches_dkv
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_dkv_plain(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("dkv", [q, k, v, do, lse, delta, dk, dv], q, k.shape[1])
    launches_dkv += 1
    return dk, dv


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's o and lse and the cotangent dO:
    delta in plain PyTorch, then K2 and K3."""
    if o.shape != q.shape:
        raise ValueError(f"want o {tuple(q.shape)}, got {tuple(o.shape)}")
    delta = attention_delta(o, do)
    return (flash_attention_dq(q, k, v, do, lse, delta), *flash_attention_dkv(q, k, v, do, lse, delta))


def flash_attention_bwd_merged(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6: (dq, dk, dv) in one pass, the same function as
    `flash_attention_bwd` (plain version `flash_attention_bwd_plain` on the
    CPU). dq is summed over key blocks in an fp32 buffer and rounded once to
    q's type, as the JAX default FAIRDIFF_MERGED_DQ32=1; the kernel adds each
    key block's tile with a bulk reduce-add, in no fixed order. Head dims
    above MERGED_MAX_D take K3 then K2 (`flash_attention_bwd`) on CUDA."""
    global launches_merged
    if o.shape != q.shape:
        raise ValueError(f"want o {tuple(q.shape)}, got {tuple(o.shape)}")
    if q.is_cuda and q.shape[-1] > MERGED_MAX_D:
        return flash_attention_bwd(q, k, v, o, lse, do)
    delta = attention_delta(o, do)
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do)
    B, S, H, D = q.shape
    dq32 = torch.zeros(B, H, -(-S // DQ_ROWS) * DQ_ROWS, D, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("bwd_merged", [q, k, v, do, lse, delta, dk, dv, dq32], q, k.shape[1])
    launches_merged += 1
    # the one cast of dq, with the transpose back to [B, S, H, D]
    return torch.empty_like(q).copy_(dq32[:, :, :S].transpose(1, 2)), dk, dv


def check_flash_bwd(flash_bwd: str) -> str:
    if flash_bwd not in FLASH_BWD:
        raise ValueError(f"flash_bwd must be one of {FLASH_BWD}, not {flash_bwd!r}")
    return flash_bwd


class FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX custom_vjp: forward with lse (K1), backward
    through K2 and K3 (`flash_bwd="split"`) or K6 (`"merged"`), with q, k,
    v, o and lse as the residuals; or (`"recompute"`) forward without lse
    (K1), q, k and v the residuals, and the backward by autograd through
    `flash_attention_plain`, recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, flash_bwd="split"):
        ctx.flash_bwd = flash_bwd  # checked by `flash_attention`
        if flash_bwd == "recompute":
            ctx.save_for_backward(q, k, v)
            return _forward(q, k, v, with_lse=False)[0]
        o, lse = flash_attention_lse(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        if ctx.flash_bwd == "recompute":
            qkv = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            with torch.enable_grad():
                o = flash_attention_plain(*qkv)
            return (*torch.autograd.grad(o, qkv, do), None)
        q, k, v, o, lse = ctx.saved_tensors
        bwd = {"split": flash_attention_bwd, "merged": flash_attention_bwd_merged}[ctx.flash_bwd]
        return (*bwd(q, k, v, o, lse, do.contiguous()), None)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, flash_bwd: str = "split"
) -> torch.Tensor:
    """Non-causal o = softmax(D**-0.5 q k^T) v; q [B,S,H,D], k/v [B,T,H,D].
    Differentiable where a gradient is wanted (through `FlashAttention`,
    whose backward `flash_bwd` selects)."""
    check_flash_bwd(flash_bwd)
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, flash_bwd)
    return _forward(q, k, v, with_lse=False)[0]
