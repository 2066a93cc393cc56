"""fairdiff_torch fused GroupNorm+SiLU (K7) against the JAX package.

The port's plain version runs here (CPU tensors); the JAX
`fused_group_norm_silu` runs its Pallas kernel in interpret mode with
FAIRDIFF_FUSED_GN=1, as tests/test_group_norm.py does. Rows (H*W) are at
least 1024 so that JAX takes the kernel. Inputs are float32 from one numpy
seed, with an offset so that the mean matters. Tolerance 2e-4 absolute on
outputs of O(1) and 1e-4 on gradients: both sides compute fp32 sum and sum of
squares per group, differing in summation order only (the JAX backward is its
XLA two-pass variance, the port's the kernel formula; the same maths).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fairdiff.models import layers as jlayers
from fairdiff.ops import group_norm as jgn
from fairdiff_torch.io.from_jax import load_jax_params
from fairdiff_torch.models.layers import FusedGroupNorm
from fairdiff_torch.ops import group_norm as tgn

torch.set_num_threads(1)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setenv("FAIRDIFF_FUSED_GN", "1")


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    bias = (0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    return x, scale, bias, dy


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape,groups", [((2, 32, 32, 320), 32), ((1, 32, 32, 384), 32)])
def test_plain_matches_jax_kernel_with_grads(interpret, shape, groups, silu):
    x, scale, bias, dy = _inputs(shape)
    assert jgn._kernel_applicable(int(np.prod(shape[1:-1])), shape[-1], groups, 4)

    def jloss(a, w, b):
        return jnp.sum(jgn.fused_group_norm_silu(a, w, b, groups, 1e-5, silu) * dy)

    want = np.asarray(jgn.fused_group_norm_silu(*map(jnp.asarray, (x, scale, bias)), groups, 1e-5, silu))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, scale, bias)))
    tx, ts, tb = (torch.from_numpy(a).requires_grad_() for a in (x, scale, bias))
    before = tgn.launches
    got = tgn.fused_group_norm_silu(tx, ts, tb, groups, 1e-5, silu)
    assert isinstance(got.grad_fn, tgn.FusedGroupNormSiLU._backward_cls)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-4)
    (got * torch.from_numpy(dy)).sum().backward()
    for t, j, name in zip((tx, ts, tb), jgrads, ("dx", "dscale", "dbias")):
        rel = np.abs(t.grad.numpy() - np.asarray(j)).max() / max(np.abs(np.asarray(j)).max(), 1.0)
        assert rel < 1e-4, name
    assert tgn.launches == before  # CPU tensors take the plain version


def test_module_matches_jax_fused_group_norm(interpret):
    """FusedGroupNorm (weights carried from the JAX module's tree) against
    the JAX `FusedGroupNorm` module: SiLU on, eps 1e-6, 1024 rows."""
    x, scale, bias, _ = _inputs((2, 32, 32, 64), seed=3)
    jmod = jlayers.FusedGroupNorm(num_groups=16, epsilon=1e-6, use_silu=True)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = load_jax_params(FusedGroupNorm(64, 16, 1e-6, use_silu=True), params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_plain_takes_every_shape_and_rejects_bad_groups():
    """No TPU applicability rule: 7 rows and C = 12 run (JAX falls back to
    XLA there, with the same maths); C % groups != 0 raises."""
    x, scale, bias, _ = _inputs((3, 7, 12), seed=5)
    want = np.asarray(jgn._xla_group_norm(*map(jnp.asarray, (x, scale, bias)), 4, 1e-5, True))
    got = tgn.fused_group_norm_silu(*map(torch.from_numpy, (x, scale, bias)), 4, 1e-5, True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    with pytest.raises(ValueError, match="groups"):
        tgn.fused_group_norm_silu(*map(torch.from_numpy, (x, scale, bias)), 5, 1e-5, True)
    with pytest.raises(ValueError, match="scale and bias"):
        tgn.fused_group_norm_silu(torch.from_numpy(x), torch.ones(6), torch.zeros(6), 4, 1e-5)


def test_row_chunks_cover_every_row():
    """The kernel's cut of a sample's rows: every row in one chunk, chunks of
    equal size but the last, about 2 blocks an SM over the batch."""
    for batch, rows in ((8, 4096), (8, 64), (1, 1), (2, 1024), (3, 7), (16, 262144)):
        per, n = tgn.row_chunks(batch, rows)
        assert per * (n - 1) < rows <= per * n and n <= rows
        assert batch * n <= 2 * 264 or per == 1
