"""Hyperspherical margin-loss heads: the opensphere face-recognition
training objectives as plain torch functions (counterpart of
fairdiff/fairness/margin_heads.py).

Each head is a loss over (weight [D, C], features [N, D], labels [N]). The
reference heads renormalise `w` in place under no_grad every forward and
compute the margin delta under no_grad; here the delta is `.detach()`ed on
exactly the terms the JAX package wraps in `stop_gradient`, and the caller
projects the stored weight back onto the sphere after each update
(`normalize_head_weight`).

All heads share:  cos = normalize(x) @ normalize(w);  logits = s*(cos + d)
with d computed without gradient; loss = CE (or BCE for SphereFace2).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / x.norm(dim=dim, keepdim=True).clamp_min(1e-12)


def normalize_head_weight(w: torch.Tensor) -> torch.Tensor:
    """Column-normalise (the in-place `w.data = normalize(w)` of every
    reference head); call on the stored weight each step."""
    return _normalize(w, 0)


def _cos_theta(x, w):
    return _normalize(x, 1) @ normalize_head_weight(w)


def _ce(logits, y):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, y[:, None])[:, 0].mean()


def _onehot(y, n, like):
    return F.one_hot(y, n).to(like.dtype)


def _scatter_to_y(base, y, value, reduce):
    """torch scatter_(1, y, v, reduce=...) on the label column."""
    onehot = _onehot(y, base.shape[1], base)
    if reduce == "add":
        return base + onehot * value
    if reduce == "multiply":
        return base * torch.where(onehot > 0, value, 1.0)
    raise ValueError(reduce)


def _arccos(cos):
    return torch.arccos(cos.clamp(-1 + 1e-5, 1 - 1e-5))


def softmax_loss(w, x, y, s: float = 1.0, use_bias_logits: Optional[torch.Tensor] = None):
    """Plain softmax head (opensphere softmaxloss.py)."""
    logits = x @ w
    if use_bias_logits is not None:
        logits = logits + use_bias_logits
    return _ce(logits, y)


def cocoloss(w, x, y, s: float = 30.0):
    """NormFace/CocoLoss (cocoloss.py)."""
    return _ce(s * _cos_theta(x, w), y)


def cosface(w, x, y, s: float = 64.0, m: float = 0.35):
    cos = _cos_theta(x, w)
    d = _scatter_to_y(torch.zeros_like(cos), y, -m, "add").detach()
    return _ce(s * (cos + d), y)


def arcface(w, x, y, s: float = 64.0, m: float = 0.5):
    cos = _cos_theta(x, w)
    theta = _arccos(cos)
    theta_m = _scatter_to_y(theta, y, m, "add").clamp(1e-5, 3.14159)
    d = (torch.cos(theta_m) - cos).detach()
    return _ce(s * (cos + d), y)


def _sphere_phi(cos, y, m):
    """multiplicative-margin phi with the (-1)^k - 2k unfolding
    (sphereface.py:36-43)."""
    m_theta = _scatter_to_y(_arccos(cos), y, m, "multiply")
    k = torch.floor(m_theta / math.pi)
    sign = -2.0 * torch.remainder(k, 2.0) + 1.0
    return sign * torch.cos(m_theta) - 2.0 * k


def sphereface(w, x, y, s: float = 30.0, m: float = 1.5):
    cos = _cos_theta(x, w)
    d = (_sphere_phi(cos, y, m) - cos).detach()
    return _ce(s * (cos + d), y)


def spherefaceplus(w, x, y, s: float = 30.0, m: float = 1.5, lambda_mhe: float = 1.0):
    """SphereFace+ = SphereFace + minimum-hyperspherical-energy term over
    the classifier columns of the classes in the batch (spherefaceplus.py).
    Pairs are weighted by batch-class presence masks, as in the JAX package
    (each present-class pair counted once, the same value as torch.unique)."""
    cos = _cos_theta(x, w)
    d = (_sphere_phi(cos, y, m) - cos).detach()
    ce = _ce(s * (cos + d), y)

    wn = normalize_head_weight(w)
    present = torch.zeros(w.shape[1], dtype=w.dtype, device=w.device)
    present[y] = 1.0
    gram = torch.arccos((wn.T @ wn).clamp(-1 + 1e-5, 1 - 1e-5))
    pair_mask = torch.triu(present[:, None] * present[None, :], diagonal=1)
    n_present = present.sum()
    mhe = (pair_mask * gram**-2).sum() / torch.clamp_min(n_present * (n_present - 1) * 0.5, 1.0)
    return ce + lambda_mhe * mhe


def gasoftmax(w, x, y, s: float = 30.0, m: float = 1.5):
    """Geodesic softmax (gasoftmaxloss.py): linear-in-angle confidence;
    gradient flows through the base angle, margin offset detached."""
    cos = _cos_theta(x, w)
    theta = _arccos(cos)
    m_theta = _scatter_to_y(theta, y, m, "multiply")
    offset = (m_theta - theta).detach()
    confid = -0.63662 * (theta + offset) + 1.0
    return _ce(s * confid, y)


def _r_d_theta(cos, y, magn_type, m):
    if magn_type == "v0":
        return _sphere_phi(cos, y, m) - cos
    m_theta = _scatter_to_y(_arccos(cos), y, m, "multiply")
    if magn_type == "v1":
        return torch.cos(m_theta.clamp(1e-5, 3.14159)) - cos
    if magn_type == "v2":
        return torch.cos(m_theta / m) - cos
    raise ValueError(magn_type)


def _mag_cos(w, x):
    mag = x.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return mag, (x @ normalize_head_weight(w)) / mag


def spherefacer_h(w, x, y, magn_type: str = "v0", s: float = 30.0,
                  m: float = 1.5, lw: float = 50.0):
    """SphereFace-R (hard feature normalisation) (spherefacer.py:73-103)."""
    _, cos = _mag_cos(w, x)
    d = _r_d_theta(cos, y, magn_type, m).detach()
    return lw * _ce(s * (cos + d), y) / s


def spherefacer_n(w, x, y, magn_type: str = "v0", m: float = 1.0, lw: float = 1.0):
    """SphereFace-R (no normalisation): logits scaled by feature magnitude."""
    mag, cos = _mag_cos(w, x)
    d = _r_d_theta(cos, y, magn_type, m).detach()
    return lw * _ce(mag * (cos + d), y)


def spherefacer_s(w, x, y, magn_type: str = "v0", s: float = 30.0,
                  m: float = 1.0, t: float = 0.01, lw: float = 50.0):
    """SphereFace-R (soft normalisation): magnitude-regularised."""
    mag, cos = _mag_cos(w, x)
    d = _r_d_theta(cos, y, magn_type, m).detach()
    loss = lw * _ce(mag * (cos + d), y) / s
    return loss + (t * (mag - s).abs()).mean()


def sphereface2(w, b, x, y, magn_type: str = "C", alpha: float = 0.7,
                r: float = 40.0, m: float = 0.4, t: float = 3.0,
                lw: float = 50.0):
    """SphereFace2 binary-classification head (sphereface2.py). `b` is the
    trainable scalar bias; init with sphereface2_bias_init."""
    num_class = w.shape[1]
    cos = _cos_theta(x, w)
    onehot = _onehot(y, num_class, cos)
    if magn_type == "C":
        g = 2.0 * ((cos + 1.0) / 2.0) ** t - 1.0
        g = g - m * (2.0 * onehot - 1.0)
    elif magn_type == "A":
        theta_m = _scatter_to_y(_arccos(cos), y, m, "add").clamp(1e-5, 3.14159)
        g = 2.0 * ((torch.cos(theta_m) + 1.0) / 2.0) ** t - 1.0
    elif magn_type == "M":
        m_theta = _scatter_to_y(_arccos(cos), y, m, "multiply").clamp(1e-5, 3.14159)
        g = 2.0 * ((torch.cos(m_theta) + 1.0) / 2.0) ** t - 1.0
    else:
        raise ValueError(magn_type)
    d = (g - cos).detach()
    logits = r * (cos + d) + b
    weight = alpha * onehot + (1.0 - alpha) * (1.0 - onehot)
    weight = lw * num_class / r * weight
    # weighted BCE-with-logits, mean over all elements (torch semantics)
    bce = torch.clamp_min(logits, 0) - logits * onehot + torch.log1p(torch.exp(-logits.abs()))
    return (weight * bce).mean()


def sphereface2_bias_init(num_class: int, magn_type: str = "C",
                          alpha: float = 0.7, r: float = 40.0, m: float = 0.4,
                          t: float = 3.0) -> float:
    z = alpha / ((1.0 - alpha) * (num_class - 1.0))
    if magn_type == "C":
        ay = r * (2.0 * 0.5**t - 1.0 - m)
        ai = r * (2.0 * 0.5**t - 1.0 + m)
    elif magn_type == "A":
        theta_y = min(math.pi, math.pi / 2.0 + m)
        ay = r * (2.0 * ((math.cos(theta_y) + 1.0) / 2.0) ** t - 1.0)
        ai = r * (2.0 * 0.5**t - 1.0)
    elif magn_type == "M":
        theta_y = min(math.pi, m * math.pi / 2.0)
        ay = r * (2.0 * ((math.cos(theta_y) + 1.0) / 2.0) ** t - 1.0)
        ai = r * (2.0 * 0.5**t - 1.0)
    else:
        raise ValueError(magn_type)
    temp = (1.0 - z) ** 2 + 4.0 * z * math.exp(ay - ai)
    return math.log(2.0 * z) - ai - math.log(1.0 - z + math.sqrt(temp))


HEADS = {
    "softmax": softmax_loss,
    "cocoloss": cocoloss,
    "cosface": cosface,
    "arcface": arcface,
    "sphereface": sphereface,
    "spherefaceplus": spherefaceplus,
    "gasoftmax": gasoftmax,
    "spherefacer_n": spherefacer_n,
    "spherefacer_h": spherefacer_h,
    "spherefacer_s": spherefacer_s,
    "sphereface2": sphereface2,
}
