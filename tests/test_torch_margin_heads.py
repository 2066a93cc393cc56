"""fairdiff_torch's margin heads against the JAX package's: every `HEADS`
entry, every SphereFace-R `magn_type` (v0/v1/v2) and every SphereFace2
`magn_type` (C/A/M), the loss and its gradients in x, w (and SphereFace2's
b) on the same seeded inputs, fp32.

Tolerances: the loss within rel 1e-5, each gradient within rel L2 1e-5
(fp32 sums in other orders); `sphereface2_bias_init` within 1e-12 (the same
float64 formula).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairdiff.fairness import margin_heads as jmh
from fairdiff_torch.fairness import margin_heads as tmh

torch.set_num_threads(1)

CASES = [(name, {}) for name in jmh.HEADS if name != "sphereface2"]
CASES += [(f"spherefacer_{v}", {"magn_type": mt}) for v in "nhs" for mt in ("v1", "v2")]
CASES += [("sphereface2", {"magn_type": mt}) for mt in ("C", "A", "M")]
CASES += [("cosface", {"s": 30.0, "m": 0.2}), ("sphereface", {"m": 2.5}),
          ("spherefaceplus", {"lambda_mhe": 0.5})]


def _data(seed, n=24, d=16, c=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) * 3
    w = rng.normal(size=(d, c)).astype(np.float32)
    y = rng.integers(0, c, n)  # repeated labels: SphereFace+'s pair mask sees duplicates
    return x, w, y


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


@pytest.mark.parametrize("name,kwargs", CASES, ids=[f"{n}-{'-'.join(map(str, k.values()))}" for n, k in CASES])
def test_head_loss_and_grads_match_jax(name, kwargs):
    x, w, y = _data(seed=len(name) + len(kwargs))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    ty = torch.tensor(y)
    if name == "sphereface2":
        b = np.float32(jmh.sphereface2_bias_init(w.shape[1], **kwargs))
        jloss, jgrads = jax.value_and_grad(
            lambda W, B, X: jmh.sphereface2(W, B, X, jnp.asarray(y), **kwargs), argnums=(0, 1, 2)
        )(jnp.asarray(w), jnp.asarray(b), jnp.asarray(x))
        tb = torch.tensor(b, requires_grad=True)
        tloss = tmh.sphereface2(tw, tb, tx, ty, **kwargs)
        tloss.backward()
        tgrads = (tw.grad, tb.grad, tx.grad)
    else:
        jloss, jgrads = jax.value_and_grad(
            lambda W, X: jmh.HEADS[name](W, X, jnp.asarray(y), **kwargs), argnums=(0, 1)
        )(jnp.asarray(w), jnp.asarray(x))
        tloss = tmh.HEADS[name](tw, tx, ty, **kwargs)
        tloss.backward()
        tgrads = (tw.grad, tx.grad)
    assert abs(tloss.item() - float(jloss)) <= 1e-5 * abs(float(jloss)), (tloss.item(), float(jloss))
    for tg, jg in zip(tgrads, jgrads):
        assert np.abs(np.asarray(jg)).max() > 0
        assert _rel(tg.numpy(), jg) <= 1e-5, _rel(tg.numpy(), jg)


@pytest.mark.parametrize("magn_type", ["C", "A", "M"])
@pytest.mark.parametrize("num_class", [2, 11, 8631, 85742])
def test_sphereface2_bias_init_matches_jax(magn_type, num_class):
    for kw in ({}, {"alpha": 0.6, "r": 30.0, "m": 0.3, "t": 2.0}):
        got = tmh.sphereface2_bias_init(num_class, magn_type, **kw)
        want = jmh.sphereface2_bias_init(num_class, magn_type, **kw)
        assert abs(got - want) <= 1e-12, (got, want)


def test_normalize_head_weight_and_registry():
    assert list(tmh.HEADS) == list(jmh.HEADS)
    w = np.random.default_rng(0).normal(size=(16, 7)).astype(np.float32)
    w[:, 3] = 0.0  # a zero column stays zero (the 1e-12 clip)
    got = tmh.normalize_head_weight(torch.tensor(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmh.normalize_head_weight(jnp.asarray(w))), rtol=1e-6, atol=1e-7)
    assert np.all(got[:, 3] == 0)
