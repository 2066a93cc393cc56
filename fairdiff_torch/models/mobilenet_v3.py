"""MobileNetV3-Large, inference only: the attribute-classifier backbone
(counterpart of fairdiff/models/mobilenet_v3.py).

torchvision's `mobilenet_v3_large` with a replaced final Linear, BatchNorm
in frozen inference form (eps 1e-3, running `mean` and `var` kept as
buffers). Takes the JAX package's NHWC images; convolutions run NCHW inside.
Submodule names follow the JAX parameter tree (`features_0` ..
`features_16`, `block_<i>`, `classifier_0`, `classifier_3`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# (kernel, expanded, out, use_se, activation, stride): torchvision "large"
LARGE_CONF = (
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
)

_ACT = {"relu": F.relu, "hardswish": F.hardswish}


class FrozenBatchNorm(nn.Module):
    """Inference-only BatchNorm over NCHW channels: (x - mean) * rsqrt(var +
    eps) * weight + bias, with the converted running statistics."""

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.var + self.eps) * self.weight
        return (x - self.mean[:, None, None]) * inv[:, None, None] + self.bias[:, None, None]


class ConvBNAct(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int, stride: int = 1, groups: int = 1,
                 act: Optional[str] = "hardswish"):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel, stride, padding=(kernel - 1) // 2,
                              groups=groups, bias=False)
        self.bn = FrozenBatchNorm(features)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return _ACT[self.act](x) if self.act else x


class SqueezeExcitation(nn.Module):
    def __init__(self, features: int, squeeze: int):
        super().__init__()
        self.fc1 = nn.Conv2d(features, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True)))
        return x * F.hardsigmoid(self.fc2(s))


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, kernel: int, expanded: int, out: int, use_se: bool, act: str,
                 stride: int):
        super().__init__()
        self.residual = stride == 1 and in_ch == out
        blocks: list[nn.Module] = []
        if expanded != in_ch:
            blocks.append(ConvBNAct(in_ch, expanded, 1, act=act))
        blocks.append(ConvBNAct(expanded, expanded, kernel, stride, groups=expanded, act=act))
        if use_se:
            blocks.append(SqueezeExcitation(expanded, _make_divisible(expanded // 4)))
        blocks.append(ConvBNAct(expanded, out, 1, act=None))
        for i, block in enumerate(blocks):
            self.add_module(f"block_{i}", block)
        self.n_blocks = len(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n_blocks):
            h = getattr(self, f"block_{i}")(h)
        return x + h if self.residual else h


class MobileNetV3Large(nn.Module):
    """images [N, H, W, 3] (the reference feeds 224x224 face chips in [-1, 1]
    without ImageNet renormalisation) -> logits [N, num_classes]."""

    def __init__(self, num_classes: int = 80):
        super().__init__()
        self.features_0 = ConvBNAct(3, 16, 3, 2)
        ch = 16
        for i, (k, exp, out, se, act, s) in enumerate(LARGE_CONF):
            self.add_module(f"features_{i + 1}", InvertedResidual(ch, k, exp, out, se, act, s))
            ch = out
        self.features_16 = ConvBNAct(ch, 960, 1)
        self.classifier_0 = nn.Linear(960, 1280)
        self.classifier_3 = nn.Linear(1280, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.classifier_0.weight.dtype).permute(0, 3, 1, 2)
        for i in range(17):
            x = getattr(self, f"features_{i}")(x)
        return self.classifier_3(F.hardswish(self.classifier_0(x.mean(dim=(2, 3)))))
