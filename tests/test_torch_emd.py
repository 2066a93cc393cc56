"""fairdiff_torch's native EMD solver (`csrc/emd.cpp` through
`fairness/emd.py`) against the JAX package's default route, its native
solver (`fairdiff/native/emd_lib.py`): the same plans exactly, ties
included, with the JAX package left as it is.

`make_fixtures` computes `fairdiff_torch/testdata/emd_fixtures.npz`, the
plans of the JAX package's native solver that `chip_smoke.py` `[emd]` holds
the port to on the card's host, where there is no JAX. Rewrite the file
with `python tests/test_torch_emd.py` (the repo root on PYTHONPATH);
`test_fixtures_are_current` fails when the committed file differs from what
the JAX solver gives now.
"""

import contextlib
import ctypes
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fairdiff.fairness import emd as jemd
from fairdiff.fairness import targets as jt
from fairdiff.native import emd_lib
from fairdiff_torch.fairness import emd as temd
from fairdiff_torch.fairness import targets as tt
from fairdiff_torch.kernels import build

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parents[1] / "fairdiff_torch" / "testdata" / "emd_fixtures.npz"
OT_SEED, OT_DRAWS = 1, 200
TIED_GENDER = np.array([[1, 0]] * 5 + [[0, 1]] * 3, np.float64)
TIED_RACE = np.array([[1, 0, 0, 0]] * 6 + [[0, 0, 1, 0]] * 2, np.float64)
TIED_ENUM = np.array([[1, 0, 0, 0]] * 5 + [[0, 1, 0, 0]] * 3, np.float64)
CASES = ["tied_ot2", "tied_enum", "identical8", "identical16", "exp3_16", "exp6_16",
         *(f"random_{i:02d}" for i in range(20))]


@contextlib.contextmanager
def _recording():
    """Record the (bs, cost) that the port's target functions hand their
    solver (the same numpy as the JAX package's)."""
    calls, solve = [], tt.emd_batch

    def record(bs, cost):
        calls.append((np.asarray(bs, np.int64), np.asarray(cost, np.float64)))
        return solve(bs, cost)

    tt.emd_batch = record
    try:
        yield calls
    finally:
        tt.emd_batch = solve


def _jax_plans(bs: np.ndarray, cost: np.ndarray) -> np.ndarray:
    plans = emd_lib.emd_batch_native(bs, cost)
    assert plans is not None, "the JAX package's native EMD solver did not build"
    return plans.astype(np.uint8)


def make_fixtures() -> dict[str, np.ndarray]:
    """{case.cost, case.bs, case.plans} for every case of CASES, the plans
    from the JAX native solver; the two tied target cases also keep their
    probabilities and the JAX package's targets and uncertainties."""
    out: dict[str, np.ndarray] = {"ot_seed": np.int64(OT_SEED), "ot_draws": np.int64(OT_DRAWS)}

    def problem(name, bs, cost):
        out[f"{name}.cost"], out[f"{name}.bs"] = cost, bs
        out[f"{name}.plans"] = _jax_plans(bs, cost)

    with _recording() as calls:
        tt.sampled_ot_targets_2attr(TIED_GENDER, TIED_RACE, np.random.default_rng(OT_SEED), OT_DRAWS)
    problem("tied_ot2", *calls[0])
    want = jt.sampled_ot_targets_2attr(TIED_GENDER, TIED_RACE, np.random.default_rng(OT_SEED), OT_DRAWS)
    out["tied_ot2.probs_gender"], out["tied_ot2.probs_race"] = TIED_GENDER, TIED_RACE
    out["tied_ot2.targets"] = np.stack([t.targets for t in want])
    out["tied_ot2.uncertainty"] = np.stack([t.uncertainty for t in want])

    with _recording() as calls:
        tt.enumerated_ot_targets(TIED_ENUM)
    problem("tied_enum", *calls[0])
    want = jt.enumerated_ot_targets(TIED_ENUM)
    out["tied_enum.probs"] = TIED_ENUM
    out["tied_enum.targets"], out["tied_enum.uncertainty"] = want.targets[None], want.uncertainty[None]

    rng = np.random.default_rng(0)
    for n in (8, 16):
        cost = np.tile(rng.random(8), (n, 1))
        bs = np.concatenate([np.eye(8, dtype=np.int64) * n,
                             np.stack([rng.multinomial(n, np.ones(8) / 8) for _ in range(24)])])
        problem(f"identical{n}", bs, cost)

    probs = np.random.default_rng(16)
    pg, pr = probs.dirichlet(np.ones(2), 16), probs.dirichlet(np.ones(4), 16)
    with _recording() as calls:
        tt.sampled_ot_targets_2attr(pg, pr, np.random.default_rng(OT_SEED), OT_DRAWS)
        tt.enumerated_ot_targets(pr)
    problem("exp3_16", *calls[0])
    problem("exp6_16", *calls[1])

    for i in range(20):
        n, c = int(rng.integers(4, 41)), int(rng.integers(2, 17))
        cost = rng.uniform(0, 3, (n, c))
        if i % 2:  # half of them on a coarse grid: ties between rows and classes
            cost = np.round(cost * 2) / 2
        bs = np.stack([rng.multinomial(n, np.ones(c) / c) for _ in range(6)])
        problem(f"random_{i:02d}", bs, cost)
    return out


@functools.lru_cache(maxsize=None)
def _committed() -> dict[str, np.ndarray]:
    return dict(np.load(FIXTURES))


def test_fixtures_are_current():
    want, got = make_fixtures(), _committed()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("case", CASES)
def test_port_reproduces_the_fixture(case):
    fx = _committed()
    bs, cost = fx[f"{case}.bs"], fx[f"{case}.cost"]
    got = temd.emd_batch(bs, cost)
    np.testing.assert_array_equal(got, fx[f"{case}.plans"].astype(np.float64))
    np.testing.assert_array_equal(got.sum(axis=1), bs)
    assert (got.sum(axis=2) == 1).all()


def test_fixture_has_ties_the_scipy_route_breaks_otherwise():
    """The tied fixtures are not vacuous: scipy's plans differ from them."""
    fx = _committed()
    for case in ("tied_ot2", "tied_enum", "identical8", "identical16"):
        scipy = temd.emd_batch(fx[f"{case}.bs"], fx[f"{case}.cost"], native=False)
        assert not np.array_equal(scipy, fx[f"{case}.plans"]), case
        np.testing.assert_allclose((scipy * fx[f"{case}.cost"]).sum(axis=(1, 2)),
                                   (fx[f"{case}.plans"] * fx[f"{case}.cost"]).sum(axis=(1, 2)), atol=1e-12)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("n,c,seed", [(1, 2, 0), (5, 3, 1), (16, 8, 2), (32, 8, 3), (40, 16, 4), (64, 4, 5)])
def test_emd_matches_the_jax_default_route(n, c, seed, tied):
    rng = np.random.default_rng(seed)
    cost = rng.random((n, c))
    if tied:
        cost = np.round(cost * 3) / 3
    bs = np.stack([rng.multinomial(n, np.ones(c) / c) for _ in range(8)])
    np.testing.assert_array_equal(temd.emd_batch(bs, cost), jemd.emd_batch(bs, cost))
    for b in bs[:3]:
        np.testing.assert_array_equal(temd.emd_assignment(b, cost), jemd.emd_assignment(b, cost))
    assert temd.emd_value(bs[0], cost) == jemd.emd_value(bs[0], cost)


def _bad(case):
    cost, bs = np.random.default_rng(0).random((4, 3)), np.array([[2, 1, 1]])
    if case == "nan":
        cost[1, 2] = np.nan
    elif case == "nan-row":  # no column is reachable from row 1
        cost[1] = np.nan
    elif case == "inf":
        cost[0, 0] = np.inf
    elif case == "inf-row":
        cost[0] = np.inf
    elif case == "-inf":
        cost[3, 1] = -np.inf
    elif case == "columns":
        bs = np.array([[2, 1, 1, 0]])
    elif case == "negative":
        bs = np.array([[5, -1, 0]])
    elif case == "mass":
        bs = np.array([[2, 1, 2]])
    return bs, cost


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("case,match", [
    ("nan", "non-finite"), ("inf", "non-finite"), ("-inf", "non-finite"), ("columns", "columns"),
    ("negative", "negative"), ("mass", "mass mismatch"),
])
def test_invalid_problems_raise(case, match, native):
    """What the JAX package's native route rejects raises ValueError on
    both of the port's routes, before the solver sees it."""
    bs, cost = _bad(case)
    with pytest.raises(ValueError):
        emd_lib.emd_batch_native(bs, cost)
    with pytest.raises(ValueError, match=match):
        temd.emd_batch(bs, cost, native=native)
    with pytest.raises(ValueError, match=match):
        temd.emd_assignment(bs[0], cost, native=native)


@pytest.mark.parametrize("case,rc", [("nan-row", 2), ("inf-row", 2), ("mass", 1), ("negative", 1)])
def test_the_library_returns_its_status_and_writes_no_plan(case, rc):
    """The C ABI on its own: a non-finite cost gives 2 (no augmenting
    column, nothing written through j1 == -1), a bad mass 1; the plan
    buffer is left untouched."""
    bs, cost = _bad(case)
    cost = np.ascontiguousarray(cost, np.float64)
    bs = np.ascontiguousarray(bs, np.int64)
    plan = np.full((4, 3), 7.0)
    f64p, i64p = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
    got = temd._lib().emd_assignment(cost.ctypes.data_as(f64p), bs.ctypes.data_as(i64p), 4, 3,
                                     plan.ctypes.data_as(f64p))
    assert got == rc
    assert (plan == 7.0).all()


def test_the_solver_is_a_host_library_built_without_fma_contraction():
    assert "emd" in build.HOST_LIBRARIES and "emd" not in build.KERNELS
    assert "-ffp-contract=off" in build.CXX_FLAGS
    temd._lib()
    assert build.library_path("emd").exists() and build.library_path("emd").parent == build.BUILD_DIR


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    """No compiler: the native route raises the build's error (the JAX
    package's loader would drop to scipy); native=False still solves."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "fresh")
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    build.load.cache_clear()
    temd._lib.cache_clear()
    try:
        cost, bs = np.random.default_rng(1).random((6, 3)), np.array([[2, 2, 2]])
        with pytest.raises(RuntimeError, match="nonexistent"):
            temd.emd_batch(bs, cost)
        with pytest.raises(RuntimeError, match="nonexistent"):
            tt.enumerated_ot_targets(np.random.default_rng(2).dirichlet(np.ones(4), 6))
        assert temd.emd_batch(bs, cost, native=False).shape == (1, 6, 3)
    finally:
        build.load.cache_clear()
        temd._lib.cache_clear()


def test_a_broken_source_raises(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "emd.cpp").write_text('extern "C" int emd_batch( {\n')
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "fresh")
    with pytest.raises(RuntimeError, match="failed for emd.cpp"):
        build.build(("emd",))
    assert not list((tmp_path / "fresh").glob("*.so"))


if __name__ == "__main__":
    FIXTURES.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURES, **make_fixtures())
    print(f"wrote {FIXTURES} ({FIXTURES.stat().st_size} bytes)", file=sys.stderr)
