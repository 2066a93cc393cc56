"""fairdiff_torch flash attention (K1) against the JAX package.

The port's plain version runs here (CPU tensors); the JAX `_flash_forward`
runs its Pallas kernel in interpret mode, as tests/test_flash_attention.py
does. Inputs are float32 from one numpy seed. Tolerance 2e-5 absolute: both
sides compute fp32 softmax attention, differing only in summation order
(online softmax over key tiles vs one softmax).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fairdiff.models import layers as jlayers
from fairdiff.ops import flash_attention as jfa
from fairdiff_torch.models import layers as tlayers
from fairdiff_torch.ops import flash_attention as tfa

torch.set_num_threads(1)


def _qkv(s, t, d, seed=0, h=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, n, h, d)).astype(np.float32) for n in (s, t, t)]


@pytest.mark.parametrize("s,t,d", [(600, 300, 40), (1024, 77, 80), (512, 512, 64)])
def test_plain_matches_jax_flash_forward(monkeypatch, s, t, d):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    q, k, v = _qkv(s, t, d)
    want = np.asarray(jfa._flash_forward(*map(jnp.asarray, (q, k, v))))
    before = tfa.launches
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert tfa.launches == before  # CPU tensors take the plain version


def test_plain_rounds_probabilities_to_input_dtype():
    """bf16 inputs: the plain version matches the JAX reference composition
    (fp32 logits, probabilities rounded to bf16 before P.V) to bf16
    resolution (2^-8 relative on outputs of magnitude <= 1)."""
    q, k, v = _qkv(64, 48, 16, seed=3)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jlayers._xla_attention(jq, jk, jv).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = tfa.flash_attention_plain(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2)


def test_dot_product_attention_routing_on_cpu(monkeypatch):
    """Long-key self-attention without bias would take the kernel on CUDA;
    on CPU tensors nothing reaches the kernel wrapper, and the result is the
    JAX package's attention (tolerance as above)."""
    calls = []
    monkeypatch.setattr(tlayers, "flash_attention", lambda *a: calls.append(a))
    q, k, v = _qkv(16, tfa.FLASH_MIN_KV, 8, seed=1)
    want = np.asarray(jlayers.dot_product_attention(*map(jnp.asarray, (q, k, v))))
    got = tlayers.dot_product_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert calls == []


def test_dot_product_attention_with_bias_matches_jax():
    q, k, v = _qkv(10, 10, 8, seed=2)
    mask = np.array([[1] * 7 + [0] * 3], np.int32)
    jbias = jlayers.expand_padding_mask(jnp.asarray(mask)) + jlayers.make_causal_mask(10)
    tbias = tlayers.expand_padding_mask(torch.from_numpy(mask)) + tlayers.make_causal_mask(10)
    np.testing.assert_array_equal(tbias.numpy(), np.asarray(jbias))
    want = np.asarray(jlayers.dot_product_attention(*map(jnp.asarray, (q, k, v)), jbias))
    got = tlayers.dot_product_attention(*map(torch.from_numpy, (q, k, v)), tbias)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_wrapper_rejects_other_devices_and_bad_shapes():
    q, k, v = (torch.zeros(1, 8, 2, 4, device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="disagree"):
        tfa.flash_attention(torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 3, 4), torch.zeros(1, 8, 3, 4))
