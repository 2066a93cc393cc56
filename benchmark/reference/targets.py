"""Dynamic class targets of exp-1, a frozen copy of the binary-rank part of
fairdiff_torch/fairness/targets.py (host numpy on the phase-1
probabilities): rank the lanes by P(class 1); the top `target_ratio` share
is class 1, the rest class 0, each with its binomial-CDF tail uncertainty;
the gate sets targets above the uncertainty threshold to -1. Rows whose
probs are -1 (no face) receive target -1."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.stats


class Targets(NamedTuple):
    targets: np.ndarray  # [N] int64, -1 fill
    uncertainty: np.ndarray  # [N] float, -1 fill


def binary_rank_targets(probs: np.ndarray, target_ratio: float = 0.5) -> Targets:
    probs = np.asarray(probs)
    n_total = probs.shape[0]
    valid = (probs != -1).all(axis=-1)
    targets_all = np.full(n_total, -1, np.int64)
    uncertainty_all = np.full(n_total, -1.0, np.float64)
    p1 = probs[valid][:, 1]
    n = p1.shape[0]
    if n > 0:
        rank = np.argsort(np.argsort(p1))
        targets = (rank >= n * target_ratio).astype(np.int64)
        targets_all[valid] = targets
        unc = np.empty(n)
        unc[targets == 1] = 1 - scipy.stats.binom.cdf(rank[targets == 1], n, 1 - target_ratio)
        unc[targets == 0] = scipy.stats.binom.cdf(rank[targets == 0], n, target_ratio)
        uncertainty_all[valid] = unc
    return Targets(targets_all, uncertainty_all)


def gate_targets_by_uncertainty(t: Targets, threshold: float) -> np.ndarray:
    """uncertainty > threshold -> target -1."""
    out = t.targets.copy()
    out[t.uncertainty > threshold] = -1
    return out
