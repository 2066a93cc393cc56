"""The control's lower precision: the reference computed with fp8 (e4m3)
operands where the configuration states bf16.

`round_` is the identity unless `fp8()` is active. Inside it, every input
and weight of an `nn.Linear` and `nn.Conv2d` and every attention operand is
rounded to e4m3 with a per-tensor scale (its largest magnitude maps to
e4m3's largest finite value, 448) before the product, which then runs in
the reference's own precision. Gradients pass the rounding unchanged
(straight through), so a gradient of the control is a gradient of its fp8
forward.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0
_active = [False]


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


def round_(x: torch.Tensor) -> torch.Tensor:
    return _fp8(x) if _active[0] else x


@contextlib.contextmanager
def fp8():
    """Run the reference with fp8 operands (the control)."""
    linear, conv = nn.Linear.forward, nn.Conv2d.forward
    nn.Linear.forward = lambda self, x: F.linear(_fp8(x), _fp8(self.weight), self.bias)
    nn.Conv2d.forward = lambda self, x: self._conv_forward(_fp8(x), _fp8(self.weight), self.bias)
    _active[0] = True
    try:
        yield
    finally:
        nn.Linear.forward, nn.Conv2d.forward = linear, conv
        _active[0] = False
