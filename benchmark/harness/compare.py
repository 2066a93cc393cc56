"""The numbers that decide `correct`, each against its limit."""

from __future__ import annotations

import numpy as np


def leaf_norms(leaves) -> np.ndarray:
    return np.array([float(x.detach().double().norm()) for x in leaves])


def worst_leaf_gap(prog: np.ndarray, ref: np.ndarray, keep: np.ndarray | None = None) -> float:
    """The widest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
    floor = float(np.median(ref))
    return float(np.max(np.abs(prog - ref) / np.maximum(ref, floor)))


def moving_leaves(ref_grad_norms: np.ndarray) -> np.ndarray:
    """Leaves whose reference gradient is not nought to rounding: at least a
    thousandth of the median leaf's."""
    return ref_grad_norms >= 1e-3 * float(np.median(ref_grad_norms))


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict[str, list[float]]]:
    """-> (every number that has a limit within it, {name: [number, limit]}).
    A number that is not finite fails; one without a limit is not compared."""
    checks = {k: [float(numbers[k]), float(lim)] for k, lim in limits.items()}
    ok = all(np.isfinite(v) and v <= lim for v, lim in checks.values())
    return ok, checks
