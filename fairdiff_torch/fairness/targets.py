"""Dynamic class targets (a copy of fairdiff/fairness/targets.py; host-side
numpy on the phase-1 probabilities).

  binary_rank_targets          exp-1/2: rank the lanes by P(class 1); the
                               top `target_ratio` share is class 1, the rest
                               class 0, each with its binomial-CDF tail
                               uncertainty.
  sampled_ot_targets_2attr     exp-3/5: per draw a random joint-class
                               (gender x race) count vector, one exact EMD
                               per draw, the plans summed and marginalised
                               per attribute.
  sampled_ot_targets_3attr     exp-4: 16 joint classes (gender x race x
                               age), a 75/25 age draw, an asymmetric
                               young-side age cost.
  enumerated_ot_targets        exp-6: race only, every multinomial count
                               vector of the top >= 0.95 mass, EMD plans
                               weighted by their probability.

The sampled generators draw from the `np.random.Generator` they are given,
in the JAX package's order, so one seeded generator gives both packages the
same draws. The gate sets targets above the uncertainty threshold to -1.
Rows whose probs are -1 (no face) receive target -1 and uncertainty -1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.stats
from scipy.special import gammaln

from fairdiff_torch.fairness.emd import emd_batch


class Targets(NamedTuple):
    targets: np.ndarray  # [N] int64, -1 fill
    uncertainty: np.ndarray  # [N] float, -1 fill


def binary_rank_targets(probs: np.ndarray, target_ratio: float = 0.5, w_uncertainty: bool = True) -> Targets:
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
        if w_uncertainty:
            unc = np.empty(n)
            unc[targets == 1] = 1 - scipy.stats.binom.cdf(rank[targets == 1], n, 1 - target_ratio)
            unc[targets == 0] = scipy.stats.binom.cdf(rank[targets == 0], n, target_ratio)
            uncertainty_all[valid] = unc
    return Targets(targets_all, uncertainty_all)


def _marginal(target_probs: np.ndarray, groups: list[list[int]]) -> np.ndarray:
    return np.stack([target_probs[:, g].sum(axis=-1) for g in groups], axis=-1)


def _finalize(valid: np.ndarray, marg: np.ndarray) -> Targets:
    n_total = valid.shape[0]
    t = np.full(n_total, -1, np.int64)
    u = np.full(n_total, -1.0, np.float64)
    t[valid] = marg.argmax(axis=-1)
    u[valid] = 1.0 - marg.max(axis=-1)
    return Targets(t, u)


def _empty(n: int) -> Targets:
    return Targets(np.full(n, -1, np.int64), np.full(n, -1.0))


def _race_draw(rng: np.random.Generator, shape: tuple[int, int]) -> np.ndarray:
    """Uniform race class 0..3 from one uniform draw per lane."""
    r = rng.random(shape)
    return (r > 0.25).astype(int) + (r > 0.5).astype(int) + (r > 0.75).astype(int)


def sampled_ot_targets_2attr(
    probs_gender: np.ndarray,
    probs_race: np.ndarray,
    rng: np.random.Generator,
    num_samples: int = 200,
) -> tuple[Targets, Targets]:
    """exp-3 semantics; `num_samples` is the total draw count (the reference
    draws 100 a device and sums the plans over its 2 devices)."""
    probs_gender = np.asarray(probs_gender)
    probs_race = np.asarray(probs_race)
    valid = (probs_gender != -1).all(axis=-1) & (probs_race != -1).all(axis=-1)
    if valid.sum() == 0:
        empty = _empty(probs_gender.shape[0])
        return empty, empty
    pg, pr = probs_gender[valid], probs_race[valid]
    n = pg.shape[0]

    # joint one-hot targets, class j = g*4 + r
    eg = np.repeat(np.eye(2), 4, axis=0)  # [8, 2]
    er = np.tile(np.eye(4), (2, 1))  # [8, 4]
    cost = np.sqrt(
        ((pg[:, None, :] - eg[None]) ** 2).sum(-1) + ((pr[:, None, :] - er[None]) ** 2).sum(-1)
    )  # [n, 8]

    g_draw = (rng.random((num_samples, n)) > 0.5).astype(int)
    joint = g_draw * 4 + _race_draw(rng, (num_samples, n))
    bs = np.stack([np.bincount(joint[d], minlength=8) for d in range(num_samples)])
    target_probs = emd_batch(bs, cost).sum(axis=0)
    target_probs /= target_probs[0].sum()

    marg_g = _marginal(target_probs, [[0, 1, 2, 3], [4, 5, 6, 7]])
    marg_r = _marginal(target_probs, [[0, 4], [1, 5], [2, 6], [3, 7]])
    return _finalize(valid, marg_g), _finalize(valid, marg_r)


def sampled_ot_targets_3attr(
    probs_gender: np.ndarray,
    probs_race: np.ndarray,
    probs_age: np.ndarray,
    rng: np.random.Generator,
    num_samples: int = 200,
    age_young_ratio: float = 0.75,
) -> tuple[Targets, Targets, Targets]:
    """exp-4 semantics: joint class j = g*8 + r*2 + a; age drawn 75/25, and
    the young-side error doubled in the cost of old-target cells."""
    probs_gender = np.asarray(probs_gender)
    probs_race = np.asarray(probs_race)
    probs_age = np.asarray(probs_age)
    valid = (
        (probs_gender != -1).all(axis=-1)
        & (probs_race != -1).all(axis=-1)
        & (probs_age != -1).all(axis=-1)
    )
    if valid.sum() == 0:
        empty = _empty(probs_gender.shape[0])
        return empty, empty, empty
    pg, pr, pa = probs_gender[valid], probs_race[valid], probs_age[valid]
    n = pg.shape[0]

    eg = np.repeat(np.eye(2), 8, axis=0)  # [16, 2]
    er = np.tile(np.repeat(np.eye(4), 2, axis=0), (2, 1))  # [16, 4]
    ea = np.tile(np.eye(2), (8, 1))  # [16, 2]
    cost_gr = ((pg[:, None, :] - eg[None]) ** 2).sum(-1) + ((pr[:, None, :] - er[None]) ** 2).sum(-1)
    young = ea[:, 0] == 1  # [16]
    c_young = (pa[:, 0] - 1) ** 2 + (pa[:, 1] - 0) ** 2  # [n]
    c_old = (pa[:, 0] * 2) ** 2 + (pa[:, 1] - 1) ** 2
    cost_age = np.where(young[None, :], c_young[:, None], c_old[:, None])
    cost = np.sqrt(cost_gr + cost_age)  # [n, 16]

    g_draw = (rng.random((num_samples, n)) > 0.5).astype(int)
    r_draw = _race_draw(rng, (num_samples, n))
    a_draw = (rng.random((num_samples, n)) > age_young_ratio).astype(int)
    joint = g_draw * 8 + r_draw * 2 + a_draw
    bs = np.stack([np.bincount(joint[d], minlength=16) for d in range(num_samples)])
    target_probs = emd_batch(bs, cost).sum(axis=0)
    target_probs /= target_probs[0].sum()

    marg_g = _marginal(target_probs, [list(range(8)), list(range(8, 16))])
    marg_r = _marginal(target_probs, [[0, 1, 8, 9], [2, 3, 10, 11], [4, 5, 12, 13], [6, 7, 14, 15]])
    marg_a = _marginal(target_probs, [[0, 2, 4, 6, 8, 10, 12, 14], [1, 3, 5, 7, 9, 11, 13, 15]])
    return _finalize(valid, marg_g), _finalize(valid, marg_r), _finalize(valid, marg_a)


def enumerate_multinomial_combs(n: int, k: int = 4, mass: float = 0.95) -> tuple[np.ndarray, np.ndarray]:
    """Every count vector over k classes for n draws of uniform class
    probability, cut to the most probable ones holding >= `mass`.
    -> (combs [M, k], probabilities [M])."""
    combs = []

    def rec(prefix, remaining, depth):
        if depth == k - 1:
            combs.append(prefix + [remaining])
            return
        for c in range(remaining + 1):
            rec(prefix + [c], remaining - c, depth + 1)

    rec([], n, 0)
    combs = np.array(combs)
    # the multinomial coefficient; the uniform p cancels in the normalisation
    coef = gammaln(n + 1) - gammaln(combs + 1).sum(axis=1)
    probs = np.exp(coef - coef.max())
    probs = probs / probs.sum()
    order = np.argsort(probs)[::-1]
    acc = np.cumsum(probs[order])
    keep = order[: int(np.searchsorted(acc, mass) + 1)]
    return combs[keep], probs[keep]


def enumerated_ot_targets(probs: np.ndarray, mass: float = 0.95) -> Targets:
    """exp-6 semantics: race only (4 classes); EMD plans of the enumerated
    count vectors weighted by their probability, row-normalised."""
    probs = np.asarray(probs)
    valid = (probs != -1).all(axis=-1)
    if valid.sum() == 0:
        return _empty(probs.shape[0])
    p = probs[valid]
    n, k = p.shape
    cost = np.sqrt(((p[:, None, :] - np.eye(k)[None]) ** 2).sum(-1))
    combs, weights = enumerate_multinomial_combs(n, k, mass)
    target_probs = (emd_batch(combs, cost) * weights[:, None, None]).sum(axis=0)
    target_probs /= np.abs(target_probs).sum(axis=-1, keepdims=True)
    return _finalize(valid, target_probs)


def gate_targets_by_uncertainty(t: Targets, threshold: float) -> np.ndarray:
    """uncertainty > threshold -> target -1."""
    out = t.targets.copy()
    out[t.uncertainty > threshold] = -1
    return out
