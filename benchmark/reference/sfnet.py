"""SFNet face-recognition backbone: the frozen face embedder of the fairness
loss (a frozen copy of fairdiff_torch/models/sfnet.py for the benchmark's
reference, opensphere's `sfnet*`).

No normalisation (biased convolutions), 112x112 input, stride-2 conv blocks
with residual basic blocks, flatten, a Linear to the 512-d embedding. The
flatten is NHWC, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn



@dataclasses.dataclass(frozen=True)
class SFNetConfig:
    layers: tuple[int, int, int, int] = (1, 2, 4, 1)  # sfnet20
    channels: tuple[int, int, int, int] = (64, 128, 256, 512)
    out_channel: int = 512
    in_size: int = 112
    # True: the legacy "sfnet*_deprecated" ordering (ReLU before the
    # residual add, no ReLU after it)
    pre_act_residual: bool = False

    @classmethod
    def sfnet20(cls):
        return cls(layers=(1, 2, 4, 1))

    @classmethod
    def tiny(cls):
        return cls(layers=(0, 0, 0, 0), channels=(8, 8, 16, 16), out_channel=32, in_size=32)

class _ConvBlock(nn.Module):
    def __init__(self, in_ch: int, planes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, planes, 3, 2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv1(x))


class _BasicBlock(nn.Module):
    def __init__(self, planes: int, pre_act_residual: bool):
        super().__init__()
        self.pre_act_residual = pre_act_residual
        self.conv1 = nn.Conv2d(planes, planes, 3, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(F.relu(self.conv1(x)))
        return F.relu(h) + x if self.pre_act_residual else F.relu(x + h)


class SFNet(nn.Module):
    """aligned faces [N, in_size, in_size, 3] -> embeddings [N, out_channel]."""

    def __init__(self, config: SFNetConfig = SFNetConfig.sfnet20()):
        super().__init__()
        self.config = cfg = config
        ch = 3
        for li, (n_blocks, planes) in enumerate(zip(cfg.layers, cfg.channels), 1):
            self.add_module(f"layer{li}_0", _ConvBlock(ch, planes))
            for bi in range(n_blocks):
                self.add_module(f"layer{li}_{bi + 1}", _BasicBlock(planes, cfg.pre_act_residual))
            ch = planes
        side = cfg.in_size // 16
        self.fc = nn.Linear(ch * side * side, cfg.out_channel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = x.to(self.fc.weight.dtype).permute(0, 3, 1, 2)
        for li, n_blocks in enumerate(cfg.layers, 1):
            for bi in range(n_blocks + 1):
                x = getattr(self, f"layer{li}_{bi}")(x)
        return self.fc(x.permute(0, 2, 3, 1).flatten(1))  # NHWC flatten
