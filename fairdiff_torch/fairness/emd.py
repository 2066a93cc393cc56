"""Exact earth-mover's distance for the dynamic-target OT problems (the
counterpart of fairdiff/fairness/emd.py and its native solver,
fairdiff/native/emd_lib.py).

Every problem has unit source masses (a = ones(N)) and integer target
masses b with sum(b) == N, so an integral optimal plan exists and the LP is
a min-cost assignment on the column-expanded cost matrix. Host work on tiny
matrices (N <= ~40, C <= 16).

Two routes, as in the JAX package:

- native (the default): `csrc/emd.cpp`, a shortest-augmenting-path solver
  built with the host's C++ compiler at first use (`kernels/build.py`) and
  bound through ctypes. Where costs tie (identical probability rows),
  several plans are optimal, and it returns the plan the JAX package's
  native solver returns. A missing compiler or a failed build raises;
  nothing falls back to scipy.
- `native=False`: scipy's `linear_sum_assignment`, the JAX package's scipy
  route. It reaches the same optimum, but may break ties differently.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
from scipy.optimize import linear_sum_assignment

from fairdiff_torch.kernels import build

_f64p = ctypes.POINTER(ctypes.c_double)
_i64p = ctypes.POINTER(ctypes.c_int64)
STATUS = {1: "mass mismatch", 2: "non-finite EMD cost matrix"}
# problems the native solver has solved in this process (chip_smoke.py sets
# it to 0 before a training step and reads it after)
solves = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("emd")
    lib.emd_assignment.restype = ctypes.c_int
    lib.emd_assignment.argtypes = [_f64p, _i64p, ctypes.c_int, ctypes.c_int, _f64p]
    lib.emd_batch.restype = ctypes.c_int
    lib.emd_batch.argtypes = [_f64p, _i64p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _f64p]
    return lib


def _validate(bs: np.ndarray, cost: np.ndarray) -> None:
    """Raise ValueError on what the solver cannot take: non-finite costs, a
    column-count mismatch, negative masses, masses that do not sum to N."""
    n, c = cost.shape
    if not np.isfinite(cost).all():
        raise ValueError("non-finite entries in EMD cost matrix")
    if bs.shape[-1] != c:
        raise ValueError(f"b has {bs.shape[-1]} columns but cost has {c}")
    if (bs < 0).any():
        raise ValueError("negative mass in b")
    sums = bs.sum(axis=-1)
    if (sums != n).any():
        k = int(np.flatnonzero(sums != n)[0])
        raise ValueError(f"mass mismatch: sum(b)={int(sums[k])} != N={n} (problem {k})")


def _native_batch(bs: np.ndarray, cost: np.ndarray) -> np.ndarray:
    d, c = bs.shape
    n = cost.shape[0]
    plans = np.zeros((d, n, c), np.float64)
    rc = _lib().emd_batch(cost.ctypes.data_as(_f64p), bs.ctypes.data_as(_i64p), d, n, c,
                          plans.ctypes.data_as(_f64p))
    if rc:
        raise ValueError(STATUS.get(rc, f"EMD solver failed with status {rc}"))
    global solves
    solves += d
    return plans


def _scipy_assignment(b: np.ndarray, cost: np.ndarray) -> np.ndarray:
    n, c = cost.shape
    col_of = np.repeat(np.arange(c), b)  # expanded column -> class
    rows, cols = linear_sum_assignment(cost[:, col_of])
    plan = np.zeros((n, c))
    plan[rows, col_of[cols]] = 1.0
    return plan


def emd_batch(bs: np.ndarray, cost: np.ndarray, *, native: bool = True) -> np.ndarray:
    """D problems against one cost matrix: bs [D, C] integer masses, cost
    [N, C] -> plans [D, N, C], 0/1, row sums 1 and column sums bs."""
    cost = np.ascontiguousarray(cost, np.float64)
    bs = np.ascontiguousarray(bs, np.int64)
    if bs.ndim != 2 or cost.ndim != 2:
        raise ValueError(f"bs must be [D, C] and cost [N, C], got {bs.shape} and {cost.shape}")
    _validate(bs, cost)
    if native:
        return _native_batch(bs, cost)
    return np.stack([_scipy_assignment(b, cost) for b in bs])


def emd_assignment(b: np.ndarray, cost: np.ndarray, *, native: bool = True) -> np.ndarray:
    """Optimal transport plan between a = ones(N) and integer masses b.

    b: [C] non-negative integers, sum(b) == N; cost: [N, C].
    -> plan [N, C], 0/1, row sums 1 and column sums b."""
    return emd_batch(np.asarray(b).reshape(1, -1), cost, native=native)[0]


def emd_value(b: np.ndarray, cost: np.ndarray) -> float:
    plan = emd_assignment(b, cost)
    return float((plan * np.asarray(cost, dtype=np.float64)).sum())
