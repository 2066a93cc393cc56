"""Bias metrics, host-side numpy over gathered probabilities (a copy of
fairdiff/training/metrics.py)."""

from __future__ import annotations

import itertools

import numpy as np


def _valid(probs: np.ndarray) -> np.ndarray:
    probs = np.asarray(probs)
    return probs[(probs != -1).all(axis=-1)]


def gender_metrics(probs_gender: np.ndarray) -> dict:
    p = _valid(probs_gender)
    if len(p) == 0:
        return {}
    p1 = p[:, 1]
    gap = float((p1 >= 0.5).mean() - (p1 < 0.5).mean())
    return {
        "gender_gap": gap,
        "gender_gap_abs": abs(gap),
        "gender_pred_between_0.2_0.8": float(((p1 >= 0.2) & (p1 <= 0.8)).mean()),
    }


def class_freq_gap(preds: np.ndarray, num_classes: int) -> float:
    """Mean pairwise |freq_i - freq_j|."""
    preds = np.asarray(preds)
    preds = preds[preds != -1]
    if len(preds) == 0:
        return float("nan")
    freqs = np.bincount(preds, minlength=num_classes) / len(preds)
    return float(np.mean([abs(a - b) for a, b in itertools.combinations(freqs, 2)]))


def multi_attr_metrics(probs: dict[str, np.ndarray], preds: dict[str, np.ndarray]) -> dict:
    out: dict[str, float] = {}
    if "gender" in probs:
        out.update(gender_metrics(probs["gender"]))
        p = _valid(probs["gender"])
        if len(p):
            out["gender_pred_below_0.8"] = float((p.max(axis=-1) < 0.8).mean())
    if "race" in probs:
        r = np.asarray(preds["race"])
        out["race_gap"] = class_freq_gap(r, 4)
        p = _valid(probs["race"])
        if len(p):
            out["race_pred_below_0.8"] = float((p.max(axis=-1) < 0.8).mean())
            freqs = np.bincount(r[r != -1], minlength=4) / max((r != -1).sum(), 1)
            for i, f in enumerate(freqs):
                out[f"race_freq_{i}"] = float(f)
    if "gender" in preds and "race" in preds:
        g, r = np.asarray(preds["gender"]), np.asarray(preds["race"])
        ok = (g != -1) & (r != -1)
        if ok.sum():
            out["gender_race_gap"] = class_freq_gap(g[ok] * 4 + r[ok], 8)
    if "age" in preds:
        a = np.asarray(preds["age"])
        a = a[a != -1]
        if len(a):
            f0 = float((a == 0).mean())
            out["age_young_freq"] = f0
            out["age_old_freq"] = 1 - f0
            out["age_gap"] = (abs(f0 - 0.75) + abs((1 - f0) - 0.25)) / 2
        p = _valid(probs["age"])
        if len(p):
            out["age_pred_below_0.8"] = float((p.max(axis=-1) < 0.8).mean())
    return out
