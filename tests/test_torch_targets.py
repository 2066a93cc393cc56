"""fairdiff_torch's exact EMD and dynamic OT targets against the JAX
package's (`fairdiff/fairness/{emd,targets}.py`), on the same numpy inputs
and the same seeded `np.random.Generator`.

Targets must be equal exactly and uncertainties within 1e-12 (the same
float64 sums). Both packages solve on their native solvers by default, and
the port's (`csrc/emd.cpp`) returns the JAX one's plan, ties included:
inputs with tied costs (identical rows) admit several optimal plans, and
there the JAX package is held on its default route, untouched. The scipy
routes are held against each other as cases of their own (`native=False`
on the port, the JAX package's native solver off).
"""

import functools

import numpy as np
import pytest
import torch

from fairdiff.fairness import emd as jemd
from fairdiff.fairness import targets as jt
from fairdiff.training import debias as jdebias
from fairdiff.training import presets as jpresets
from fairdiff_torch.fairness import emd as temd
from fairdiff_torch.fairness import targets as tt
from fairdiff_torch.training import debias as tdebias
from fairdiff_torch.training import presets as tpresets

torch.set_num_threads(1)

UNC_ATOL = 1e-12


@pytest.fixture
def jax_scipy_route(monkeypatch):
    """The JAX package without its native EMD solver: its scipy route."""
    from fairdiff.native import emd_lib

    monkeypatch.setattr(emd_lib, "emd_batch_native", lambda *a: None)
    monkeypatch.setattr(emd_lib, "emd_assignment_native", lambda *a: None)


@pytest.fixture(params=["native", "scipy"])
def route(request, monkeypatch):
    """Both packages on their default (native) solvers, or both on scipy's:
    the port's targets through `emd_batch(..., native=False)`."""
    if request.param == "scipy":
        request.getfixturevalue("jax_scipy_route")
        monkeypatch.setattr(tt, "emd_batch", functools.partial(temd.emd_batch, native=False))
    return request.param


def _same(got: tt.Targets, want: jt.Targets) -> None:
    np.testing.assert_array_equal(got.targets, want.targets)
    assert got.targets.dtype == want.targets.dtype
    np.testing.assert_allclose(got.uncertainty, want.uncertainty, rtol=0, atol=UNC_ATOL)


def _probs(rng, n, k):
    return rng.dirichlet(np.ones(k), n)


@pytest.mark.parametrize("n,c,seed", [(6, 2, 0), (12, 4, 1), (32, 8, 2), (40, 16, 3)])
def test_emd_matches_jax_scipy_route(n, c, seed):
    rng = np.random.default_rng(seed)
    cost = rng.random((n, c))
    bs = np.stack([np.bincount(rng.integers(0, c, n), minlength=c) for _ in range(5)])
    want = np.stack([jemd.emd_assignment(b, cost, native=False) for b in bs])
    got = temd.emd_batch(bs, cost, native=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.sum(axis=2), np.ones((5, n)))  # one class a lane
    np.testing.assert_array_equal(got.sum(axis=1), bs)  # the target masses
    np.testing.assert_array_equal(temd.emd_batch(bs, cost), want)  # one optimum: both routes agree
    assert temd.emd_value(bs[0], cost) == pytest.approx(float((want[0] * cost).sum()), abs=1e-12)


def test_emd_batch_matches_the_jax_route_with_ties(route):
    """A cost matrix of identical rows: every assignment is optimal."""
    cost = np.tile(np.random.default_rng(4).random(4), (8, 1))
    bs = np.array([[2, 2, 2, 2], [8, 0, 0, 0], [1, 3, 0, 4]])
    native = route == "native"
    np.testing.assert_array_equal(temd.emd_batch(bs, cost, native=native), jemd.emd_batch(bs, cost))
    np.testing.assert_array_equal(temd.emd_assignment(bs[2], cost, native=native),
                                  jemd.emd_assignment(bs[2], cost, native=native))


def test_emd_rejects_a_mass_mismatch():
    with pytest.raises(ValueError, match="mass mismatch"):
        temd.emd_assignment(np.array([1, 1]), np.zeros((3, 2)))


@pytest.mark.parametrize("n", [5, 16, 32])
@pytest.mark.parametrize("draws", [60, 200])
def test_sampled_ot_2attr_matches_jax(n, draws):
    rng = np.random.default_rng(100 + n)
    pg, pr = _probs(rng, n, 2), _probs(rng, n, 4)
    jg, jr = jt.sampled_ot_targets_2attr(pg, pr, np.random.default_rng(7), draws)
    tg, tr = tt.sampled_ot_targets_2attr(pg, pr, np.random.default_rng(7), draws)
    _same(tg, jg)
    _same(tr, jr)
    assert set(np.unique(tg.targets)) <= {0, 1} and set(np.unique(tr.targets)) <= {0, 1, 2, 3}


@pytest.mark.parametrize("n", [5, 12, 40])
def test_sampled_ot_3attr_matches_jax(n):
    rng = np.random.default_rng(200 + n)
    pg, pr, pa = _probs(rng, n, 2), _probs(rng, n, 4), _probs(rng, n, 2)
    want = jt.sampled_ot_targets_3attr(pg, pr, pa, np.random.default_rng(8), 200)
    got = tt.sampled_ot_targets_3attr(pg, pr, pa, np.random.default_rng(8), 200)
    for g, w in zip(got, want):
        _same(g, w)


def test_sampled_ot_leaves_the_generator_where_jax_does():
    """Both sides take the same draws from the generator, in the same order."""
    rng = np.random.default_rng(5)
    pg, pr, pa = _probs(rng, 6, 2), _probs(rng, 6, 4), _probs(rng, 6, 2)
    ja, ta = np.random.default_rng(9), np.random.default_rng(9)
    jt.sampled_ot_targets_2attr(pg, pr, ja, 30)
    tt.sampled_ot_targets_2attr(pg, pr, ta, 30)
    jt.sampled_ot_targets_3attr(pg, pr, pa, ja, 30)
    tt.sampled_ot_targets_3attr(pg, pr, pa, ta, 30)
    assert ja.random() == ta.random()


@pytest.mark.parametrize("n", [4, 8, 32])
def test_enumerate_multinomial_combs_matches_jax(n):
    jc, jw = jt.enumerate_multinomial_combs(n, 4, 0.95)
    tc, tw = tt.enumerate_multinomial_combs(n, 4, 0.95)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tw, jw)
    assert tw.sum() >= 0.95 and (tc.sum(axis=1) == n).all()


@pytest.mark.parametrize("n", [6, 16, 32])
def test_enumerated_ot_matches_jax(n):
    probs = _probs(np.random.default_rng(300 + n), n, 4)
    _same(tt.enumerated_ot_targets(probs), jt.enumerated_ot_targets(probs))


@pytest.mark.parametrize("kind", ["ot2", "ot3", "enum"])
def test_tied_rows_match_the_jax_route(kind, route):
    """Identical rows (the case of tests/test_fairness.py's enumerated-OT
    test): every lane costs the same, so the plan is one of many."""
    n = 8
    pg = np.tile([0.9, 0.1], (n, 1))
    pr = np.tile([0.97, 0.01, 0.01, 0.01], (n, 1))
    pa = np.tile([0.3, 0.7], (n, 1))
    if kind == "ot2":
        got = tt.sampled_ot_targets_2attr(pg, pr, np.random.default_rng(1), 60)
        want = jt.sampled_ot_targets_2attr(pg, pr, np.random.default_rng(1), 60)
    elif kind == "ot3":
        got = tt.sampled_ot_targets_3attr(pg, pr, pa, np.random.default_rng(1), 60)
        want = jt.sampled_ot_targets_3attr(pg, pr, pa, np.random.default_rng(1), 60)
    else:
        got, want = (tt.enumerated_ot_targets(pr),), (jt.enumerated_ot_targets(pr),)
    for g, w in zip(got, want):
        _same(g, w)
        assert (g.targets != -1).all()


TIED_GENDER = np.array([[1, 0]] * 5 + [[0, 1]] * 3, np.float64)
TIED_RACE = np.array([[1, 0, 0, 0]] * 6 + [[0, 0, 1, 0]] * 2, np.float64)
TIED_ENUM = np.array([[1, 0, 0, 0]] * 5 + [[0, 1, 0, 0]] * 3, np.float64)


@pytest.mark.parametrize("kind", ["ot2", "enum"])
def test_saturated_rows_match_the_jax_default_route(kind):
    """Saturated one-hot rows (a classifier at 0/1, or duplicate logits):
    the port on its default route gives the JAX package's default targets;
    its scipy route breaks the ties otherwise (race lanes 3 and 4 for ot2:
    [0 1 1 1 3 0 2 3] against [0 1 1 3 1 0 2 3]; lane 2 for enum)."""
    if kind == "ot2":
        want = jt.sampled_ot_targets_2attr(TIED_GENDER, TIED_RACE, np.random.default_rng(1), 200)
        got = tt.sampled_ot_targets_2attr(TIED_GENDER, TIED_RACE, np.random.default_rng(1), 200)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tt, "emd_batch", functools.partial(temd.emd_batch, native=False))
            scipy = tt.sampled_ot_targets_2attr(TIED_GENDER, TIED_RACE, np.random.default_rng(1), 200)
    else:
        want, got = (jt.enumerated_ot_targets(TIED_ENUM),), (tt.enumerated_ot_targets(TIED_ENUM),)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tt, "emd_batch", functools.partial(temd.emd_batch, native=False))
            scipy = (tt.enumerated_ot_targets(TIED_ENUM),)
    for g, w in zip(got, want):
        _same(g, w)
    assert not np.array_equal(scipy[-1].targets, want[-1].targets)


PHASE1_TIED = {
    "gender": TIED_GENDER.astype(np.float32),
    "race": TIED_RACE.astype(np.float32),
    "age": np.array([[1, 0]] * 4 + [[0, 1]] * 4, np.float32),
}


def _bare_trainer(cls, cfg):
    """A trainer with only what `make_targets` reads: its config, no mesh."""
    trainer = object.__new__(cls)
    trainer.cfg, trainer.mesh = cfg, None
    return trainer


@pytest.mark.parametrize("gate", ["preset", "open"])
@pytest.mark.parametrize("preset", ["exp3", "exp4", "exp6"])
def test_make_targets_matches_the_jax_trainer_on_tied_probs(preset, gate):
    """`DebiasTrainer.make_targets` (ot2, ot3, enum) on tied phase-1
    probabilities against the JAX trainer's, the same generator on both
    sides; "open" lifts the uncertainty gate so every tie shows."""
    over = {}
    if gate == "open":
        over["uncertainty_thresholds"] = (1.0,) * len(tpresets.PRESETS[preset]().attributes)
    tcfg, jcfg = tpresets.PRESETS[preset](**over), jpresets.PRESETS[preset](**over)
    assert tcfg.target_kind == jcfg.target_kind
    got = _bare_trainer(tdebias.DebiasTrainer, tcfg).make_targets(PHASE1_TIED, np.random.default_rng(3))
    want = _bare_trainer(jdebias.DebiasTrainer, jcfg).make_targets(PHASE1_TIED, np.random.default_rng(3))
    assert sorted(got) == sorted(want) == sorted(tcfg.attributes)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _with_fill(rng, n, k, rows):
    p = _probs(rng, n, k)
    p[rows] = -1
    return p


def test_fill_rows_get_minus_one():
    """Lanes without a face (probs -1 in any attribute) get target and
    uncertainty -1 on both sides; the others match."""
    rng = np.random.default_rng(11)
    n = 10
    pg, pr, pa = _with_fill(rng, n, 2, [1]), _with_fill(rng, n, 4, [4, 7]), _with_fill(rng, n, 2, [9])
    for got, want in (
        (tt.sampled_ot_targets_2attr(pg, pr, np.random.default_rng(2), 60),
         jt.sampled_ot_targets_2attr(pg, pr, np.random.default_rng(2), 60)),
        (tt.sampled_ot_targets_3attr(pg, pr, pa, np.random.default_rng(2), 60),
         jt.sampled_ot_targets_3attr(pg, pr, pa, np.random.default_rng(2), 60)),
        ((tt.enumerated_ot_targets(pr),), (jt.enumerated_ot_targets(pr),)),
    ):
        for g, w in zip(got, want):
            _same(g, w)
    tg, _ = tt.sampled_ot_targets_2attr(pg, pr, np.random.default_rng(2), 60)
    assert (tg.targets[[1, 4, 7]] == -1).all() and (tg.uncertainty[[1, 4, 7]] == -1).all()
    assert (tg.targets[[0, 2, 3, 5, 6, 8, 9]] != -1).all()


def test_all_invalid_batch():
    pg, pr, pa = -np.ones((5, 2)), -np.ones((5, 4)), -np.ones((5, 2))
    rng_t, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    for got, want in (
        (tt.sampled_ot_targets_2attr(pg, pr, rng_t, 60), jt.sampled_ot_targets_2attr(pg, pr, rng_j, 60)),
        (tt.sampled_ot_targets_3attr(pg, pr, pa, rng_t, 60), jt.sampled_ot_targets_3attr(pg, pr, pa, rng_j, 60)),
        ((tt.enumerated_ot_targets(pr),), (jt.enumerated_ot_targets(pr),)),
    ):
        for g, w in zip(got, want):
            _same(g, w)
            assert (g.targets == -1).all() and (g.uncertainty == -1).all()
    assert rng_t.random() == rng_j.random()  # nothing drawn on either side


@pytest.mark.parametrize("threshold", [0.05, 0.2, 0.5])
def test_gate_matches_jax(threshold):
    rng = np.random.default_rng(12)
    pg, pr = _probs(rng, 16, 2), _probs(rng, 16, 4)
    for g, w in zip(tt.sampled_ot_targets_2attr(pg, pr, np.random.default_rng(4), 60),
                    jt.sampled_ot_targets_2attr(pg, pr, np.random.default_rng(4), 60)):
        np.testing.assert_array_equal(
            tt.gate_targets_by_uncertainty(g, threshold), jt.gate_targets_by_uncertainty(w, threshold)
        )
