"""Fused GEGLU: forward (kernel K4), input gradient (kernel K5), their plain
PyTorch versions and the autograd Function that joins them.

Counterpart of fairdiff/ops/geglu.py `_geglu_forward` (K4), `_geglu_dx`
(K5) and the custom_vjp `fused_geglu` (`_fg_fwd` / `_fg_bwd`). The CUDA
kernels are `csrc/geglu.cu`; they read the feed-forward's own `proj`
Linear weight [2I, d] (torch layout) and bias [2I], so the module keeps one
parameter tree whichever path runs. On a CPU tensor each wrapper runs its
plain version; on a CUDA tensor it launches its kernel or raises. `geglu`
is the entry point the models call: where a gradient is wanted it goes
through `FusedGEGLU`, otherwise it runs the forward kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from fairdiff_torch.kernels import build
from fairdiff_torch.ops import counting

# kernel launches, counted where each kernel is launched (not under a CUDA
# graph's capture: `fairdiff_torch.ops`): K4 and K5 (one count a call; K5
# is two CUDA launches, three at split K)
launches = 0
launches_dx = 0

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
# K4's bf16 kernel (csrc/geglu.cu `k4`), one persistent block an SM: its y
# tiles as (rows, columns of each half). Ping-pong: the block's two consumer
# warpgroups take 64-row tiles in turn; cooperative: they split a 128-row
# tile, 128 columns wide or 64 narrow
FWD_PINGPONG, FWD_WIDE, FWD_NARROW = (64, 128), (128, 128), (128, 64)
FWD_TILES = (FWD_PINGPONG, FWD_WIDE, FWD_NARROW)
FWD_PINGPONG_MAX_D = 320  # five 64-deep K slots
_WAVES = 4
# K5's dx GEMM (csrc/geglu.cu `gm`): output tiles of 128 rows and 320
# columns where d is a multiple of 320, else 160; 64-deep K tiles, the two
# halves of its K = 2I each rounded up to 64 columns
DX_TILE_ROWS, DX_TILE_PART, DX_DEPTH = 128, 160, 64
_SMS = 132  # the H100's SMs: one wave of K4 or K5 tiles


@functools.lru_cache(maxsize=None)
def _kernel(name: str, dtype: torch.dtype):
    """The C entry `fd_geglu_<name>_<dtype>`: pointers, then M, d, I (and
    K4's tile rows and columns, or K5's split count), stream."""
    fn = getattr(build.load("geglu"), f"fd_geglu_{name}_{_DTYPES[dtype]}")
    ints = {"fwd": 5, "dx": 4}[name]
    fn.argtypes = [ctypes.c_void_p] * {"fwd": 4, "dx": 7}[name] + [ctypes.c_int] * ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dx_inner_pad(inner: int) -> int:
    """I rounded up to K5's 64-deep K tile: the width of each half of its
    scratch dproj [M, 2 Ip]."""
    return -(-inner // DX_DEPTH) * DX_DEPTH


def dx_splits(m: int, d: int, inner: int) -> int:
    """K5's split of the dx product's K = 2 Ip over blocks: 1 where its
    output tiles fill the card, else enough to fill about one wave of its
    132 SMs, each split at least four K tiles deep."""
    cols = 2 * DX_TILE_PART if d % (2 * DX_TILE_PART) == 0 else DX_TILE_PART
    tiles = -(-m // DX_TILE_ROWS) * -(-d // cols)
    k_tiles = 2 * dx_inner_pad(inner) // DX_DEPTH
    return max(1, min(k_tiles // 4, _SMS // tiles))


def fwd_tile(m: int, d: int, inner: int) -> tuple[int, int]:
    """K4's y tile (rows, columns) for x [m, d] and I = `inner`.

    Ping-pong where d is at most five K slots deep and its tiles fill four
    waves of the 132 SMs: there the erff epilogue is as long as a tile's
    products, and one warpgroup's runs while the other's products do.
    Deeper, the cooperative tile, whose products run at the full rate: the
    wide one, unless the narrow one lowers the busiest SM's work (its count
    of tiles times their columns: one block an SM walks every 132nd tile)
    by more than a tenth, which happens only where the wide tiles number
    under four waves (the mid block). No split K: gelu is not linear in a
    partial sum, so a split would need a second pass over fp32 partials of
    both halves."""
    def tiles(tile: tuple[int, int]) -> int:
        return -(-m // tile[0]) * -(-inner // tile[1])

    def busiest(tile: tuple[int, int]) -> int:
        return -(-tiles(tile) // _SMS) * tile[1]

    if d <= FWD_PINGPONG_MAX_D and tiles(FWD_PINGPONG) >= _WAVES * _SMS:
        return FWD_PINGPONG
    return FWD_NARROW if busiest(FWD_NARROW) < 0.9 * busiest(FWD_WIDE) else FWD_WIDE


def _acc(x: torch.Tensor) -> torch.Tensor:
    """The accumulation type: fp32, or fp64 for fp64 inputs (references)."""
    return x if x.dtype == torch.float64 else x.float()


def _gelu_grad(z: torch.Tensor) -> torch.Tensor:
    """d gelu(z) / dz = Phi(z) + z phi(z) (exact erf form)."""
    return 0.5 * (1.0 + torch.erf(z * 2.0**-0.5)) + z * torch.exp(-0.5 * z * z) * (2.0 * torch.pi) ** -0.5


def geglu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Same maths without the kernel: the [.., 2I] projection in the input
    type, then h * gelu(gate) in fp32 (fairdiff `_xla_geglu`)."""
    proj = F.linear(x, w, b).float()
    h, gate = proj.chunk(2, dim=-1)
    return (h * F.gelu(gate, approximate="none")).to(x.dtype)


def _dproj(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dy2: torch.Tensor):
    """(dh, dg) [M, I] in the input type: h and g from exact products with
    fp32 accumulation plus the fp32 bias, dh = dy gelu(g), dg = dy h gelu'(g)."""
    proj = _acc(x2) @ _acc(w).T + _acc(b)
    h, g = proj.chunk(2, dim=-1)
    dyf = _acc(dy2)
    return (dyf * F.gelu(g, approximate="none")).to(x2.dtype), (dyf * h * _gelu_grad(g)).to(x2.dtype)


def geglu_dx_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K5 without the kernel: dx = dh.Wh + dg.Wg, dh/dg rounded to the input
    type, dx accumulated in fp32 and rounded once (`_dx_kernel`)."""
    d = x.shape[-1]
    dh, dg = _dproj(x.reshape(-1, d), w, b, dy.reshape(-1, dy.shape[-1]))
    inner = w.shape[0] // 2
    dx = _acc(dh) @ _acc(w[:inner]) + _acc(dg) @ _acc(w[inner:])
    return dx.to(x.dtype).reshape(x.shape)


def _needs_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    d = x.shape[-1]
    if w.dim() != 2 or w.shape[1] != d or w.shape[0] % 2 or b.shape != (w.shape[0],):
        raise ValueError(f"want w [2I, {d}] and b [2I]; got {tuple(w.shape)}, {tuple(b.shape)}")
    if not (x.dtype == w.dtype == b.dtype):
        raise TypeError(f"mixed dtypes {x.dtype}, {w.dtype}, {b.dtype}")
    if not (x.device == w.device == b.device):
        raise ValueError("x, w and b must be on one device")


def _check_cuda(x: torch.Tensor, w: torch.Tensor, *rest: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"geglu runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes bfloat16 or float32, not {x.dtype}")
    if not all(t.is_contiguous() for t in (x, w, *rest)):
        raise ValueError("the kernel reads contiguous x, w and b")
    if x.dtype == torch.bfloat16 and (x.shape[-1] % 8 or x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("the bf16 kernel reads 16-byte rows: d % 8 == 0, x and w 16-byte aligned")


def _forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(x, w, b)
    if x.device.type == "cpu":
        return geglu_plain(x, w, b)
    d = x.shape[-1]
    return _launch_fwd(x, w, b, fwd_tile(x.numel() // d, d, w.shape[0] // 2))


def geglu_with_tile(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tile: tuple[int, int]) -> torch.Tensor:
    """K4 on CUDA tensors with its y tile (rows, columns) given, one of
    FWD_TILES. `_forward` takes `fwd_tile`'s; the others are there to be
    timed and tested beside it."""
    _check(x, w, b)
    return _launch_fwd(x, w, b, tile)


def _launch_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tile: tuple[int, int]) -> torch.Tensor:
    global launches
    _check_cuda(x, w, b)
    if _needs_grad(x, w, b):
        raise RuntimeError(
            "the kernel's output has no grad_fn: call geglu (or FusedGEGLU.apply) "
            "for a result that carries gradients"
        )
    d, inner = x.shape[-1], w.shape[0] // 2
    y = torch.empty(*x.shape[:-1], inner, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel("fwd", x.dtype)(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel() // d, d, inner, *tile, stream
        )
    if rc != 0:
        raise RuntimeError(f"geglu kernel launch failed: CUDA error {rc}")
    if counting():
        launches += 1
    return y


def geglu_dx(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dx [..., d] of y = h * gelu(gate) for the cotangent dy [..., I], through
    K5 (plain version on the CPU). In bf16 K5 writes dh and dg, rounded, into
    a scratch dproj [M, 2 Ip] and multiplies it by W; at split K it sums fp32
    partials [splits, M, d] in a third launch (both allocated here)."""
    global launches_dx
    _check(x, w, b)
    d, inner = x.shape[-1], w.shape[0] // 2
    if dy.shape != (*x.shape[:-1], inner) or dy.dtype != x.dtype:
        raise ValueError(f"want dy {(*x.shape[:-1], inner)} in {x.dtype}; got {tuple(dy.shape)} {dy.dtype}")
    if x.device.type == "cpu":
        return geglu_dx_plain(x, w, b, dy)
    _check_cuda(x, w, b, dy)
    if x.dtype == torch.float32 and d > 1280:
        raise ValueError(f"the fp32 dx kernel takes d up to 1280, not {d}")
    m = x.numel() // d
    dx = torch.empty_like(x)
    dproj = part = None
    splits = 1
    if x.dtype == torch.bfloat16:
        splits = dx_splits(m, d, inner)
        dproj = torch.empty(m, 2 * dx_inner_pad(inner), dtype=x.dtype, device=x.device)
        if splits > 1:
            part = torch.empty(splits, m, d, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel("dx", x.dtype)(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            None if dproj is None else dproj.data_ptr(), None if part is None else part.data_ptr(),
            m, d, inner, splits, stream,
        )
    if rc != 0:
        raise RuntimeError(f"geglu dx kernel launch failed: CUDA error {rc}")
    if counting():
        launches_dx += 1
    return dx


class FusedGEGLU(torch.autograd.Function):
    """Counterpart of the JAX custom_vjp: forward through K4, dx through K5;
    dW and db in plain PyTorch only when asked for (the UNet's feed-forward
    is frozen on exp-1's path, so they are not)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return _forward(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        dy = dy.contiguous()
        dx = geglu_dx(x, w, b, dy) if ctx.needs_input_grad[0] else None
        dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            d = x.shape[-1]
            dh, dg = _dproj(x.reshape(-1, d), w, b, dy.reshape(-1, dy.shape[-1]))
            dproj = _acc(torch.cat([dh, dg], dim=-1))
            dw = (dproj.T @ _acc(x.reshape(-1, d))).to(w.dtype)
            db = dproj.sum(0).to(b.dtype)
        return dx, dw, db


def geglu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y[..., I] = h * gelu(gate) with [h | gate] = x[..., d] @ w[2I, d]^T + b.
    Differentiable where a gradient is wanted (through `FusedGEGLU`)."""
    if _needs_grad(x, w, b):
        return FusedGEGLU.apply(x, w, b)
    return _forward(x, w, b)
