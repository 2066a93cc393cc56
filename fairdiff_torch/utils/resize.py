"""Image resize with `jax.image.resize` semantics (antialias on), for the
guidance zoo's parity with the JAX package.

`F.interpolate` does not antialias when it downsamples by default and its
bicubic uses a = -0.75; `jax.image.resize` antialiases with a scaled
triangle (linear) or Keys cubic (a = -0.5) kernel. So the linear and cubic
methods build jax's `scale_and_translate` weights as a dense [in, out]
matrix per resized axis and contract the image with it: exact, cheap at the
zoo's sizes (512 -> 256 -> 224, a 37x37 position grid) and differentiable.
"nearest" gathers at floor((i + 0.5) * in / out), jax's rule (torch's
"nearest-exact").
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_METHODS = {"nearest": "nearest", "linear": "linear", "bilinear": "linear", "trilinear": "linear",
            "triangle": "linear", "cubic": "cubic", "bicubic": "cubic", "tricubic": "cubic"}


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=None)
def weight_matrix(in_size: int, out_size: int, method: str) -> torch.Tensor:
    """[in, out] fp32 interpolation weights of jax's `compute_weight_mat`
    (scale out/in, no translation, antialias when downsampling)."""
    kernel = {"linear": _triangle, "cubic": _keys_cubic}[_METHODS[method]]
    f32 = np.float32
    inv_scale = f32(in_size) / f32(out_size)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = kernel(x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.from_numpy(np.where(inside[None, :], w, 0).astype(f32))


def resize(x: torch.Tensor, shape: tuple[int, ...], method: str) -> torch.Tensor:
    """`jax.image.resize(x, shape, method)`: every axis whose size changes
    is resized (batch and channel axes keep theirs)."""
    if len(shape) != x.dim():
        raise ValueError(f"shape {tuple(shape)} does not match x of rank {x.dim()}")
    if method not in _METHODS:
        raise ValueError(f"resize method {method!r}: want one of {sorted(_METHODS)}")
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        if _METHODS[method] == "nearest":
            idx = ((torch.arange(n, dtype=torch.float32) + 0.5) * m / n).floor().long()
            x = x.index_select(d, idx.clamp_max(m - 1).to(x.device))
        else:
            w = weight_matrix(m, n, method).to(x.device, x.dtype)
            x = torch.tensordot(x, w, dims=([d], [0])).movedim(-1, d)
    return x
