"""IResNet face-recognition backbone (opensphere/insightface family):
counterpart of fairdiff/models/iresnet.py.

3x3 stem (stride 1) + BN + PReLU, four stages of IBasicBlocks
(BN-conv-BN-PReLU-conv-BN + 1x1 downsample), final BN -> flatten -> fc ->
feature BN. 112x112 -> /16 -> 7x7 spatial. BatchNorms are the frozen
inference form of `mobilenet_v3.FrozenBatchNorm` (running statistics as
buffers). Takes NHWC images and flattens NHWC before `fc`, as the JAX
package does, so its trees load by name (`io.from_jax.load_jax_params`);
`convert_iresnet` reads opensphere's checkpoints and moves the flatten
permutation into `fc`.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from fairdiff_torch.io import torch_convert as tc
from fairdiff_torch.models.mobilenet_v3 import FrozenBatchNorm


@dataclasses.dataclass(frozen=True)
class IResNetConfig:
    layers: tuple[int, int, int, int] = (2, 2, 2, 2)  # iresnet18
    out_channel: int = 512
    in_size: int = 112

    @classmethod
    def iresnet18(cls):
        return cls((2, 2, 2, 2))

    @classmethod
    def iresnet34(cls):
        return cls((3, 4, 6, 3))

    @classmethod
    def iresnet50(cls):
        return cls((3, 4, 14, 3))

    @classmethod
    def iresnet100(cls):
        return cls((3, 13, 30, 3))

    @classmethod
    def tiny(cls):
        return cls((1, 1, 1, 1), out_channel=16, in_size=32)

    @property
    def widths(self) -> tuple[int, int, int, int]:
        base = 16 if self.out_channel <= 32 else 64  # the JAX package's rule: tiny heads get a narrow net
        return (base, base * 2, base * 4, base * 8)


class PReLU(nn.Module):
    """Per-channel PReLU over NCHW; `alpha` starts at 0.25 (flax's init in
    the JAX package, torch's default)."""

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, x * self.alpha[:, None, None])


def _bn(features: int) -> FrozenBatchNorm:
    return FrozenBatchNorm(features, eps=1e-5)


class IBasicBlock(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = _bn(in_ch)
        self.conv1 = nn.Conv2d(in_ch, planes, 3, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.prelu = PReLU(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, padding=1, bias=False)
        self.bn3 = _bn(planes)
        self.downsample = stride != 1 or in_ch != planes
        if self.downsample:
            self.downsample_conv = nn.Conv2d(in_ch, planes, 1, stride, bias=False)
            self.downsample_bn = _bn(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(self.bn1(x))))))
        if self.downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return x + h


class IResNet(nn.Module):
    """aligned faces [N, in_size, in_size, 3] -> embeddings [N, out_channel]."""

    def __init__(self, config: IResNetConfig = IResNetConfig.iresnet18()):
        super().__init__()
        self.config = cfg = config
        widths = cfg.widths
        self.conv1 = nn.Conv2d(3, widths[0], 3, padding=1, bias=False)
        self.bn1 = _bn(widths[0])
        self.prelu = PReLU(widths[0])
        ch = widths[0]
        for li, (n_blocks, w) in enumerate(zip(cfg.layers, widths), 1):
            for bi in range(n_blocks):
                self.add_module(f"layer{li}_{bi}", IBasicBlock(ch, w, stride=2 if bi == 0 else 1))
                ch = w
        self.bn2 = _bn(widths[3])
        side = cfg.in_size // 16
        self.fc = nn.Linear(widths[3] * side * side, cfg.out_channel)
        self.features = _bn(cfg.out_channel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = x.to(self.fc.weight.dtype).permute(0, 3, 1, 2)
        x = self.prelu(self.bn1(self.conv1(x)))
        for li, n_blocks in enumerate(cfg.layers, 1):
            for bi in range(n_blocks):
                x = getattr(self, f"layer{li}_{bi}")(x)
        x = self.fc(self.bn2(x).permute(0, 2, 3, 1).flatten(1))  # NHWC flatten
        return self.features(x[:, :, None, None]).flatten(1)


def convert_iresnet(sd: tc.Tensors, config: IResNetConfig) -> dict:
    """opensphere IResNet state_dict -> the JAX package's parameter tree
    (numpy). Handles the NCHW->NHWC flatten permutation of the fc kernel."""
    def prelu(prefix):
        return {"alpha": tc._np(sd[f"{prefix}.weight"])}

    params: dict = {
        "conv1": tc.conv(sd, "conv1", bias=False),
        "bn1": tc.batchnorm(sd, "bn1"),
        "prelu": prelu("prelu"),
        "bn2": tc.batchnorm(sd, "bn2"),
        "features": tc.batchnorm(sd, "features"),
    }
    for li, n_blocks in enumerate(config.layers, 1):
        for bi in range(n_blocks):
            p = f"layer{li}.{bi}"
            node = {
                "bn1": tc.batchnorm(sd, f"{p}.bn1"),
                "conv1": tc.conv(sd, f"{p}.conv1", bias=False),
                "bn2": tc.batchnorm(sd, f"{p}.bn2"),
                "prelu": prelu(f"{p}.prelu"),
                "conv2": tc.conv(sd, f"{p}.conv2", bias=False),
                "bn3": tc.batchnorm(sd, f"{p}.bn3"),
            }
            if f"{p}.downsample.0.weight" in sd:
                node["downsample_conv"] = tc.conv(sd, f"{p}.downsample.0", bias=False)
                node["downsample_bn"] = tc.batchnorm(sd, f"{p}.downsample.1")
            params[f"layer{li}_{bi}"] = node
    w = tc._np(sd["fc.weight"])  # [out, C*H*W] with torch's CHW flatten
    side = config.in_size // 16
    c = w.shape[1] // (side * side)
    w = w.reshape(-1, c, side, side).transpose(0, 2, 3, 1).reshape(w.shape[0], -1)
    params["fc"] = {"kernel": w.T, "bias": tc._np(sd["fc.bias"])}
    return params
