"""Attribute-classifier weight conversion, torchvision mobilenet_v3_large
state_dict -> MobileNetV3Large parameter tree (a copy of
fairdiff/io/classifiers.py).

Covers the reference's trained classifiers: torchvision layout
`features.{i}.block.{j}.{0,1,...}` with a replaced `classifier.3`.
"""

from __future__ import annotations

from typing import Any

from fairdiff_torch.io import torch_convert as tc
from fairdiff_torch.models.mobilenet_v3 import LARGE_CONF


def _conv_bn(sd: tc.Tensors, prefix: str) -> dict:
    return {
        "conv": tc.conv(sd, f"{prefix}.0", bias=False),
        "bn": tc.batchnorm(sd, f"{prefix}.1"),
    }


def convert_mobilenet_v3(sd: tc.Tensors) -> dict:
    params: dict[str, Any] = {"features_0": _conv_bn(sd, "features.0")}
    for i, (k, exp, out, se, act, s) in enumerate(LARGE_CONF):
        p = f"features.{i + 1}.block"
        node: dict[str, Any] = {}
        idx = 0
        # expand conv present iff expanded != in_channels
        in_ch = 16 if i == 0 else LARGE_CONF[i - 1][2]
        if exp != in_ch:
            node[f"block_{idx}"] = _conv_bn(sd, f"{p}.{idx}")
            idx += 1
        node[f"block_{idx}"] = _conv_bn(sd, f"{p}.{idx}")
        idx += 1
        if se:
            node[f"block_{idx}"] = {
                "fc1": tc.conv(sd, f"{p}.{idx}.fc1"),
                "fc2": tc.conv(sd, f"{p}.{idx}.fc2"),
            }
            idx += 1
        node[f"block_{idx}"] = _conv_bn(sd, f"{p}.{idx}")
        params[f"features_{i + 1}"] = node
    params["features_16"] = _conv_bn(sd, "features.16")
    params["classifier_0"] = tc.linear(sd, "classifier.0")
    params["classifier_3"] = tc.linear(sd, "classifier.3")
    return params
