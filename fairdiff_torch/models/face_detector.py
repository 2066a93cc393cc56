"""Batched face detector (counterpart of fairdiff/models/face_detector.py).

SCRFD-style and anchor-free: a residual CNN backbone with stride 4..32
feature maps, an FPN (lateral 1x1, top-down nearest upsample and add, 3x3
smooth), a shared head per level giving {score [A], box distances [4A],
5-point landmark offsets [10A]}, A anchors a position. `decode_detections`
turns the distances into boxes around stride-spaced centres;
`select_largest_face` keeps the largest confident face of each image (a
masked argmax, no NMS), which is all the fairness loop consumes.

The public call takes the JAX package's NHWC images in [-1, 1] and returns
the raw head maps NHWC, as the JAX module does; inside, convolutions run
NCHW. Submodule names follow the JAX parameter tree, so `assets/detector.npz`
(the repository's trained weights) loads by path (`load_detector_npz`).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from fairdiff_torch.guidance.faces import FaceDetections
from fairdiff_torch.io.adapters_io import load_adapters
from fairdiff_torch.io.from_jax import load_jax_params
from fairdiff_torch.utils.resize import resize


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    strides: tuple[int, ...] = (4, 8, 16, 32)
    num_anchors: int = 2
    width: int = 32  # backbone stem width
    head_width: int = 64
    score_threshold: float = 0.6
    scores_are_logits: bool = True

    @classmethod
    def tiny(cls) -> "DetectorConfig":
        return cls(width=8, head_width=16)


class _Block(nn.Module):
    """conv-GN-relu-conv-GN, a 1x1 projection where the shape changes, add,
    relu (flax GroupNorm: 8 groups, eps 1e-6)."""

    def __init__(self, in_ch: int, features: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride, padding=1)
        self.norm1 = nn.GroupNorm(8, features, eps=1e-6)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.norm2 = nn.GroupNorm(8, features, eps=1e-6)
        if in_ch != features or stride != 1:
            self.proj = nn.Conv2d(in_ch, features, 1, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.norm1(self.conv1(x)))
        h = self.norm2(self.conv2(h))
        if hasattr(self, "proj"):
            x = self.proj(x)
        return F.relu(x + h)


class FaceDetectorNet(nn.Module):
    """images [N, H, W, 3] in [-1, 1] -> {"score", "bbox", "kps"}: one NHWC
    map a pyramid level each, in `config.strides` order."""

    def __init__(self, config: DetectorConfig = DetectorConfig()):
        super().__init__()
        self.config = cfg = config
        w, f = cfg.width, cfg.head_width
        self.stem = nn.Conv2d(3, w, 3, 2, padding=1)
        self.c2_block = _Block(w, w, 2)  # stride 4
        self.c3_block = _Block(w, w * 2, 2)  # stride 8
        self.c4_block = _Block(w * 2, w * 4, 2)  # stride 16
        self.c5_block = _Block(w * 4, w * 8, 2)  # stride 32
        in_ch = {4: w, 8: w * 2, 16: w * 4, 32: w * 8}
        for s in cfg.strides:
            self.add_module(f"lat_s{s}", nn.Conv2d(in_ch[s], f, 1))
            self.add_module(f"smooth_s{s}", nn.Conv2d(f, f, 3, padding=1))
        # one head shared by every level
        self.head_conv1 = nn.Conv2d(f, f, 3, padding=1)
        self.head_conv2 = nn.Conv2d(f, f, 3, padding=1)
        self.cls = nn.Conv2d(f, cfg.num_anchors, 1)
        self.box = nn.Conv2d(f, cfg.num_anchors * 4, 1)
        self.kps = nn.Conv2d(f, cfg.num_anchors * 10, 1)

    def forward(self, images: torch.Tensor) -> dict[str, list[torch.Tensor]]:
        cfg = self.config
        x = F.relu(self.stem(images.to(self.stem.weight.dtype).permute(0, 3, 1, 2)))
        c2 = self.c2_block(x)
        c3 = self.c3_block(c2)
        c4 = self.c4_block(c3)
        c5 = self.c5_block(c4)
        backbone = {4: c2, 8: c3, 16: c4, 32: c5}
        prev = None
        by_stride = {}
        for s in sorted(cfg.strides, reverse=True):  # top-down
            p = getattr(self, f"lat_s{s}")(backbone[s])
            if prev is not None:
                p = p + resize(prev, tuple(p.shape), "nearest")
            by_stride[s] = prev = p
        out: dict[str, list[torch.Tensor]] = {"score": [], "bbox": [], "kps": []}
        for s in cfg.strides:
            h = F.relu(self.head_conv2(F.relu(self.head_conv1(getattr(self, f"smooth_s{s}")(by_stride[s])))))
            for name, head in (("score", self.cls), ("bbox", self.box), ("kps", self.kps)):
                out[name].append(head(h).permute(0, 2, 3, 1))
        return out


def _decode_level(score, bbox, kps, stride: int, scores_are_logits: bool = True):
    """SCRFD distance decode: centres at stride-spaced grid points; box and
    landmark regressions are distances in stride units."""
    n, h, w, a = score.shape
    dev = score.device
    cy = (torch.arange(h, dtype=torch.float32, device=dev) * stride).reshape(1, h, 1, 1)
    cx = (torch.arange(w, dtype=torch.float32, device=dev) * stride).reshape(1, 1, w, 1)
    bbox = bbox.float().reshape(n, h, w, a, 4) * stride
    boxes = torch.stack(
        [cx - bbox[..., 0], cy - bbox[..., 1], cx + bbox[..., 2], cy + bbox[..., 3]], dim=-1
    ).reshape(n, -1, 4)
    kps = kps.float().reshape(n, h, w, a, 5, 2) * stride
    kps_abs = torch.stack([kps[..., 0] + cx[..., None], kps[..., 1] + cy[..., None]], dim=-1)
    scores = score.float()
    if scores_are_logits:
        scores = torch.sigmoid(scores)
    return scores.reshape(n, -1), boxes, kps_abs.reshape(n, -1, 5, 2)


def decode_detections(raw: dict[str, list[torch.Tensor]], config: DetectorConfig):
    """-> (scores [N, K], boxes [N, K, 4], kps [N, K, 5, 2]) over all anchors."""
    if len(raw["score"]) != len(config.strides):
        # zip would pair levels with the wrong strides (half-scale boxes, no error)
        raise ValueError(
            f"{len(raw['score'])} pyramid levels vs strides {config.strides}: "
            "decode config does not match the net"
        )
    levels = [
        _decode_level(s, b, k, stride, config.scores_are_logits)
        for s, b, k, stride in zip(raw["score"], raw["bbox"], raw["kps"], config.strides)
    ]
    return tuple(torch.cat(parts, dim=1) for parts in zip(*levels))


def select_largest_face(scores, boxes, kps, threshold: float, fill_value: float = -1.0) -> FaceDetections:
    """Largest confident face per image (the reference's get_largest_face_app)
    as a masked argmax over the batch."""
    area = (boxes[..., 2] - boxes[..., 0]).clamp_min(0) * (boxes[..., 3] - boxes[..., 1]).clamp_min(0)
    ok = scores >= threshold
    best = torch.where(ok, area, -torch.inf).argmax(dim=1)
    rows = torch.arange(scores.shape[0], device=scores.device)
    indicators = ok.any(dim=1)

    def fill(x: torch.Tensor) -> torch.Tensor:
        return torch.where(indicators.reshape((-1,) + (1,) * (x.dim() - 1)), x, fill_value)

    return FaceDetections(
        indicators=indicators,
        bboxes=fill(boxes[rows, best]),
        landmarks=fill(kps[rows, best]),
        scores=fill(scores[rows, best]),
    )


def make_detect_fn(net: FaceDetectorNet, config: DetectorConfig) -> Callable[[torch.Tensor], FaceDetections]:
    """detect(images [N, H, W, 3]) -> the largest confident face of each."""

    def detect(images: torch.Tensor) -> FaceDetections:
        scores, boxes, kps = decode_detections(net(images), config)
        return select_largest_face(scores, boxes, kps, config.score_threshold)

    return detect


def load_detector_npz(path: str | Path, dtype: torch.dtype = torch.float32,
                      device: torch.device | str = "cpu") -> FaceDetectorNet:
    """`FaceDetectorNet(DetectorConfig())` with the weights of a detector
    `.npz` (`|`-joined JAX tree paths, e.g. assets/detector.npz), frozen."""
    net = load_jax_params(FaceDetectorNet(DetectorConfig()), load_adapters(path))
    return net.to(device, dtype).eval().requires_grad_(False)
