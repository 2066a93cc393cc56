"""Exact earth-mover's distance for the dynamic-target OT problems (a copy
of fairdiff/fairness/emd.py on its scipy route).

Every problem has unit source masses (a = ones(N)) and integer target
masses b with sum(b) == N, so an integral optimal plan exists and the LP is
a min-cost assignment on the column-expanded cost matrix, solved exactly by
scipy's `linear_sum_assignment`. Host numpy on tiny matrices (N <= ~40,
C <= 16). Where several plans are optimal (tied costs), the tie is broken
as scipy breaks it, which is how the JAX package breaks it without its
native solver.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def emd_assignment(b: np.ndarray, cost: np.ndarray) -> np.ndarray:
    """Optimal transport plan between a = ones(N) and integer masses b.

    b: [C] non-negative integers, sum(b) == N; cost: [N, C].
    -> plan [N, C], 0/1, row sums 1 and column sums b."""
    b = np.asarray(b)
    cost = np.asarray(cost, dtype=np.float64)
    n, c = cost.shape
    if int(b.sum()) != n:
        raise ValueError(f"mass mismatch: sum(b)={int(b.sum())} != N={n}")
    col_of = np.repeat(np.arange(c), b)  # expanded column -> class
    rows, cols = linear_sum_assignment(cost[:, col_of])
    plan = np.zeros((n, c))
    plan[rows, col_of[cols]] = 1.0
    return plan


def emd_batch(bs: np.ndarray, cost: np.ndarray) -> np.ndarray:
    """D problems against one cost matrix: bs [D, C] -> plans [D, N, C]."""
    return np.stack([emd_assignment(b, cost) for b in np.asarray(bs)])


def emd_value(b: np.ndarray, cost: np.ndarray) -> float:
    plan = emd_assignment(b, cost)
    return float((plan * np.asarray(cost, dtype=np.float64)).sum())
