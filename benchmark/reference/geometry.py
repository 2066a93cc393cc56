"""Differentiable face geometry: bbox maths, batched crops, similarity
alignment, NHWC (a frozen copy of fairdiff_torch/guidance/geometry.py for
the benchmark's reference).

Every warp is one batched bilinear gather, differentiable in the images (the
fairness loss backpropagates through crop and alignment in phase 4). The
JAX package maps a per-image function over the batch; here the batch is a
leading dimension.
"""

from __future__ import annotations

import numpy as np
import torch

# ArcFace canonical 112x112 5-point template (exp-1:296-303)
ARCFACE_TEMPLATE = np.array(
    [
        [38.2946, 51.6963],  # left eye
        [73.5318, 51.5014],  # right eye
        [56.0252, 71.7366],  # nose
        [41.5493, 92.3655],  # left mouth corner
        [70.7299, 92.2041],  # right mouth corner
    ],
    dtype=np.float32,
)


def expand_bbox(bbox: torch.Tensor, expand_coef: float, target_ratio: float = 1.0) -> torch.Tensor:
    """Grow [..., 4] boxes [x0, y0, x1, y1] by `expand_coef` along the long
    side and pad the short side to the ratio h/w = `target_ratio`; rounded
    half to even and returned as int32, as the JAX function."""
    x0, y0, x1, y1 = bbox.float().unbind(-1)
    w, h = x1 - x0, y1 - y0
    ratio = h / torch.where(w == 0, torch.ones_like(w), w)
    tall = ratio > target_ratio
    more_h_tall = h * expand_coef
    more_w_tall = (h + more_h_tall) / target_ratio - w
    more_w_wide = w * expand_coef
    more_h_wide = (w + more_w_wide) * target_ratio - h
    more_w = torch.where(tall, more_w_tall, more_w_wide)
    more_h = torch.where(tall, more_h_tall, more_h_wide)
    out = torch.stack([x0 - 0.5 * more_w, y0 - 0.5 * more_h, x1 + 0.5 * more_w, y1 + 0.5 * more_h], -1)
    return torch.round(out).to(torch.int32)


def bilinear_sample(images: torch.Tensor, coords: torch.Tensor, fill_value: float = 0.0) -> torch.Tensor:
    """images [N, H, W, C], coords [N, h, w, 2] (x, y) pixel coordinates ->
    [N, h, w, C]: bilinear sampling at pixel centres, `fill_value` outside."""
    N, H, W, C = images.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = (x - x0)[..., None], (y - y0)[..., None]
    flat = images.reshape(N, H * W, C)

    def gather(ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        idx = iy.clamp(0, H - 1).long() * W + ix.clamp(0, W - 1).long()
        vals = torch.gather(flat, 1, idx.reshape(N, -1, 1).expand(-1, -1, C)).reshape(*ix.shape, C)
        return torch.where(valid[..., None], vals, fill_value)

    top = gather(x0, y0) * (1 - dx) + gather(x0 + 1, y0) * dx
    bot = gather(x0, y0 + 1) * (1 - dx) + gather(x0 + 1, y0 + 1) * dx
    return top * (1 - dy) + bot * dy


def _pixel_grid(h: int, w: int, device: torch.device) -> torch.Tensor:
    vv, uu = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([uu, vv], dim=-1)  # [h, w, 2] (x, y)


def warp_affine(
    images: torch.Tensor, mats: torch.Tensor, out_hw: tuple[int, int], fill_value: float = 0.0
) -> torch.Tensor:
    """Batched affine warp: output pixel (u, v) samples the input at
    M^-1 (u, v, 1); mats [N, 2, 3] map source to destination pixels."""
    mats = mats.float()
    a, t = mats[:, :, :2], mats[:, :, 2]
    inv_a = torch.linalg.inv(a)
    grid = _pixel_grid(*out_hw, images.device)
    src = (grid[None] - t[:, None, None, :]) @ inv_a.transpose(-1, -2)[:, None]
    return bilinear_sample(images, src, fill_value)


def crop_and_resize(
    images: torch.Tensor, bboxes: torch.Tensor, target_size: int, fill_value: float = -1.0
) -> torch.Tensor:
    """Crop each (possibly out-of-bounds) box, pad with `fill_value`, resize
    to target_size^2: one bilinear warp mapping the box onto the output."""
    b = bboxes.float()
    sx = (b[:, 2] - b[:, 0]) / target_size
    sy = (b[:, 3] - b[:, 1]) / target_size
    # dst -> src: x_src = x0 + (u + .5) * sx - .5 (pixel-centre convention)
    grid = _pixel_grid(target_size, target_size, images.device)
    src_x = b[:, 0, None, None] + 0.5 * sx[:, None, None] - 0.5 + grid[None, ..., 0] * sx[:, None, None]
    src_y = b[:, 1, None, None] + 0.5 * sy[:, None, None] - 0.5 + grid[None, ..., 1] * sy[:, None, None]
    return bilinear_sample(images, torch.stack([src_x, src_y], dim=-1), fill_value)


def estimate_similarity(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Closed-form Umeyama similarity mapping src -> dst, both [N, K, 2]
    (or [K, 2]); returns [N, 2, 3] (or [2, 3]) affines. SVD of the 2x2
    covariance; the result does not depend on the SVD's sign convention."""
    src, dst = src.float(), dst.float()
    mu_s, mu_d = src.mean(dim=-2), dst.mean(dim=-2)
    sc, dc = src - mu_s[..., None, :], dst - mu_d[..., None, :]
    k = src.shape[-2]
    cov = dc.transpose(-1, -2) @ sc / k
    u, s, vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
    diag = torch.stack([torch.ones_like(d), d], dim=-1)
    r = (u * diag[..., None, :]) @ vt
    var_s = (sc**2).sum(dim=(-1, -2)) / k
    scale = (s * diag).sum(-1) / torch.where(var_s == 0, torch.ones_like(var_s), var_s)
    t = mu_d - scale[..., None] * (r @ mu_s[..., None])[..., 0]
    return torch.cat([scale[..., None, None] * r, t[..., None]], dim=-1)


def align_faces(
    images: torch.Tensor, landmarks: torch.Tensor, out_size: int = 112, fill_value: float = -1.0
) -> torch.Tensor:
    """Similarity-align the 5 landmarks [N, 5, 2] to the ArcFace template and
    warp; images in [-1, 1] (the reference pads with 0 in [0, 255], which
    is -1 here, hence the default fill)."""
    template = torch.as_tensor(ARCFACE_TEMPLATE, device=landmarks.device)
    mats = estimate_similarity(landmarks, template.expand_as(landmarks))
    return warp_affine(images, mats, (out_size, out_size), fill_value)
