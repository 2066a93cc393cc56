"""fairdiff_torch flash attention (K1) against the JAX package.

The port's plain version runs here (CPU tensors); the JAX `_flash_forward`
runs its Pallas kernel in interpret mode, as tests/test_flash_attention.py
does. Inputs are float32 from one numpy seed. Tolerance 2e-5 absolute: both
sides compute fp32 softmax attention, differing only in summation order
(online softmax over key tiles vs one softmax).
"""

import dataclasses
import functools

import jax
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


@pytest.mark.parametrize("s,t,d", [(600, 300, 40), (1024, 77, 80), (512, 512, 64), (600, 300, 160)])
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


def _record_attention(monkeypatch):
    """Wrap the port's attention core, in `layers` and in the UNet module
    that imported it, recording (use_flash, key length) of every call."""
    from fairdiff_torch.models import unet2d

    calls = []
    real = tlayers.dot_product_attention

    def recording(q, k, v, bias=None, flash_bwd="split", use_flash=False, key_mask=None):
        calls.append((use_flash, k.shape[1]))
        return real(q, k, v, bias, flash_bwd, use_flash=use_flash, key_mask=key_mask)

    monkeypatch.setattr(tlayers, "dot_product_attention", recording)
    monkeypatch.setattr(unet2d, "dot_product_attention", recording)
    return calls


def test_only_the_unet_asks_for_flash(monkeypatch):
    """The flash kernel is asked for only where the JAX package sets
    `use_flash`: the UNet's attention (StableDiffusion passes it to the UNet
    alone, fairdiff/sampling/pipeline.py). CLIP text, CLIP vision and DINOv2
    keep the JAX default, False, so on CUDA they never reach K1 whatever
    their token count."""
    from fairdiff_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from fairdiff_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
    from fairdiff_torch.models.dinov2 import DINOv2Config, DINOv2Model
    from fairdiff_torch.models.unet2d import UNet2DCondition, UNetConfig

    assert jlayers.MultiHeadAttention.__dataclass_fields__["use_flash"].default is False  # JAX's default
    calls = _record_attention(monkeypatch)
    g = torch.Generator().manual_seed(0)
    text = CLIPTextModel(dataclasses.replace(CLIPTextConfig(), hidden_size=32, intermediate_size=64,
                                             num_hidden_layers=2, num_attention_heads=4, vocab_size=100))
    vision = CLIPVisionModel(CLIPVisionConfig.tiny())
    dino = DINOv2Model(DINOv2Config.tiny())
    with torch.no_grad():
        text(torch.randint(0, 99, (2, 77), generator=g))
        vision(torch.randn(2, 28, 28, 3, generator=g))
        dino(torch.randn(2, 56, 56, 3, generator=g))
        n_zoo = len(calls)
        cfg = UNetConfig.tiny()
        UNet2DCondition(cfg)(torch.randn(1, 8, 8, 4, generator=g), torch.tensor([10]),
                             torch.randn(1, 5, cfg.cross_attention_dim, generator=g))
    assert n_zoo == 6 and all(not flash for flash, _ in calls[:n_zoo])
    assert len(calls) > n_zoo and all(flash for flash, _ in calls[n_zoo:])


def test_mha_passes_its_flag_to_the_core(monkeypatch):
    """MultiHeadAttention(use_flash=True) hands the flag on; the default
    hands on False."""
    calls = _record_attention(monkeypatch)
    x = torch.randn(1, 6, 8)
    with torch.no_grad():
        tlayers.MultiHeadAttention(8, 2)(x)
        tlayers.MultiHeadAttention(8, 2, use_flash=True)(x)
    assert calls == [(False, 6), (True, 6)]


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


# -- K1 with lse, K2, K3 and the autograd Function ----------------------------
# The JAX `_flash_forward(with_lse=True)` and `_flash_backward` run their
# Pallas kernels in interpret mode; float32 inputs. Tolerances 2e-5 absolute
# on o, lse and the gradients (fp32 sums over up to 1024 keys in another
# order; gradients of O(1)).

BWD_SHAPES = [(512, 512, 64), (600, 300, 40), (1024, 77, 80), (1024, 1024, 40), (600, 300, 160)]


def _bwd_inputs(s, t, d, seed=4):
    q, k, v = _qkv(s, t, d, seed=seed)
    do = np.random.default_rng(seed + 1).normal(size=q.shape).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("s,t,d", BWD_SHAPES)
def test_lse_and_bwd_plain_match_jax_kernels(monkeypatch, s, t, d):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    q, k, v, do = _bwd_inputs(s, t, d)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = jfa._flash_forward(jq, jk, jv, with_lse=True)  # lse [B*H, s_pad, 128]
    B, S, H, D = q.shape
    want_lse = np.asarray(jlse)[:, :S, 0].reshape(B, H, S)
    want = [np.asarray(x) for x in jfa._flash_backward(jq, jk, jv, jo, jlse, jdo)]

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    before = (tfa.launches_lse, tfa.launches_dq, tfa.launches_dkv)
    o, lse = tfa.flash_attention_lse(tq, tk, tv)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=2e-5)
    got = tfa.flash_attention_bwd(tq, tk, tv, o, lse, tdo)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5, err_msg=name)
    assert (tfa.launches_lse, tfa.launches_dq, tfa.launches_dkv) == before  # CPU: plain versions


@pytest.mark.parametrize("s,t,d", [(600, 300, 40), (512, 512, 64)])
def test_flash_function_grads_match_jax_grad(monkeypatch, s, t, d):
    """The autograd Function on CPU tensors (plain forward with lse, plain
    backward) against jax.grad of the custom_vjp `flash_attention`."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    q, k, v, do = _bwd_inputs(s, t, d, seed=7)
    jloss = lambda a, b, c: jnp.sum(jfa.flash_attention(a, b, c) * jnp.asarray(do))
    want = [np.asarray(x) for x in jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv)
    assert isinstance(out.grad_fn, tfa.FlashAttention._backward_cls)
    (out * torch.from_numpy(do)).sum().backward()
    for x, w, name in zip((tq, tk, tv), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(x.grad.numpy(), w, atol=2e-5, err_msg=name)


def test_bf16_bwd_plain_rounds_like_the_tpu_kernels(monkeypatch):
    """bf16 inputs: p and ds are rounded to bf16 before their products in
    both; outputs agree to bf16 resolution (2^-8 relative, atol 2e-2 on
    gradients of magnitude <= 2)."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    q, k, v, do = _bwd_inputs(64, 600, 40, seed=9)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jo, jlse = jfa._flash_forward(jq, jk, jv, with_lse=True)
    want = [np.asarray(x.astype(jnp.float32)) for x in jfa._flash_backward(jq, jk, jv, jo, jlse, jdo)]
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    o, lse = tfa.flash_attention_lse(tq, tk, tv)
    got = tfa.flash_attention_bwd(tq, tk, tv, o, lse, tdo)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, atol=2e-2, rtol=1e-2)


# -- the merged backward (K6) and the flash_bwd route ---------------------------
# The JAX `flash_attention` with FAIRDIFF_FLASH_BWD=merged runs
# `_flash_backward_merged` (Pallas, interpret mode) in its custom_vjp; the
# port's `flash_bwd="merged"` runs K6's plain version on CPU tensors. Float32,
# 2e-5 absolute as above (the merged kernel sums dq over key blocks in
# another order).


@pytest.mark.parametrize("s,t,d", [(600, 300, 40), (512, 512, 64), (1024, 77, 80), (600, 300, 160)])
def test_merged_route_grads_match_jax_merged(monkeypatch, s, t, d):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setenv("FAIRDIFF_FLASH_BWD", "merged")
    q, k, v, do = _bwd_inputs(s, t, d, seed=11)
    jloss = lambda a, b, c: jnp.sum(jfa.flash_attention(a, b, c) * jnp.asarray(do))
    want = [np.asarray(x) for x in jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = (tfa.launches_merged, tfa.launches_dq, tfa.launches_dkv)
    (tfa.flash_attention(tq, tk, tv, flash_bwd="merged") * torch.from_numpy(do)).sum().backward()
    for x, w, name in zip((tq, tk, tv), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(x.grad.numpy(), w, atol=2e-5, err_msg=name)
    assert (tfa.launches_merged, tfa.launches_dq, tfa.launches_dkv) == before  # CPU: plain version


def test_merged_plain_matches_jax_merged_kernel(monkeypatch):
    """`flash_attention_bwd_merged` on CPU tensors against the JAX
    `_flash_backward_merged` on the same o and lse (ragged S and T)."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    q, k, v, do = _bwd_inputs(200, 129, 40, seed=13)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = jfa._flash_forward(jq, jk, jv, with_lse=True)
    want = [np.asarray(x) for x in jfa._flash_backward_merged(jq, jk, jv, jo, jlse, jdo)]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_attention_lse(tq, tk, tv)
    got = tfa.flash_attention_bwd_merged(tq, tk, tv, o, lse, tdo)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5, err_msg=name)


def test_merged_plain_matches_jax_merged_kernel_at_d144(monkeypatch):
    """The merged route has no head-dim limit of its own (K6 takes every D up
    to MAX_D): `flash_attention_bwd_merged` on CPU tensors at D = 144, ragged
    S and T, against the JAX `_flash_backward_merged`."""
    assert not hasattr(tfa, "MERGED_MAX_D") and tfa.MAX_D == 160
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    q, k, v, do = _bwd_inputs(200, 129, 144, seed=19)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = jfa._flash_forward(jq, jk, jv, with_lse=True)
    want = [np.asarray(x) for x in jfa._flash_backward_merged(jq, jk, jv, jo, jlse, jdo)]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_attention_lse(tq, tk, tv)
    got = tfa.flash_attention_bwd_merged(tq, tk, tv, o, lse, tdo)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5, err_msg=name)


# -- the recompute route ----------------------------------------------------------
# The JAX `flash_attention` with FAIRDIFF_FLASH_BWD=recompute keeps no lse and
# differentiates `_xla_attention` in its backward; the port's
# `flash_bwd="recompute"` runs the lse-free forward and differentiates
# `flash_attention_plain`. Float32, 2e-5 absolute as above.


@pytest.mark.parametrize("s,t,d", [(600, 300, 40), (512, 512, 64), (1024, 77, 80), (600, 300, 160)])
def test_recompute_route_grads_match_jax_recompute(monkeypatch, s, t, d):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setenv("FAIRDIFF_FLASH_BWD", "recompute")
    q, k, v, do = _bwd_inputs(s, t, d, seed=17)
    jloss = lambda a, b, c: jnp.sum(jfa.flash_attention(a, b, c) * jnp.asarray(do))
    want = [np.asarray(x) for x in jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = tuple(getattr(tfa, n) for n in ("launches", "launches_lse", "launches_dq", "launches_dkv",
                                             "launches_merged"))
    out = tfa.flash_attention(tq, tk, tv, flash_bwd="recompute")
    assert isinstance(out.grad_fn, tfa.FlashAttention._backward_cls)
    (out * torch.from_numpy(do)).sum().backward()
    for x, w, name in zip((tq, tk, tv), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(x.grad.numpy(), w, atol=2e-5, err_msg=name)
    assert tuple(getattr(tfa, n) for n in ("launches", "launches_lse", "launches_dq", "launches_dkv",
                                           "launches_merged")) == before  # CPU: plain versions


def test_recompute_saves_no_lse_and_reaches_the_unet():
    """The route's residuals are q, k and v alone, and the UNet and the
    pipeline take it."""
    from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion

    q, k, v = (torch.randn(1, 16, 2, 8, requires_grad=True) for _ in range(3))
    out = tfa.flash_attention(q, k, v, flash_bwd="recompute")
    assert len(out.grad_fn.saved_tensors) == 3
    assert len(tfa.flash_attention(q, k, v).grad_fn.saved_tensors) == 5
    unet = StableDiffusion(SDConfig.tiny(), device="cpu", flash_bwd="recompute").unet
    assert {m.flash_bwd for m in unet.modules() if hasattr(m, "to_q")} == {"recompute"}


def test_bad_flash_bwd_raises():
    q, k, v = (torch.zeros(1, 8, 2, 4) for _ in range(3))
    with pytest.raises(ValueError, match="flash_bwd"):
        tfa.flash_attention(q, k, v, flash_bwd="pallas")
    from fairdiff_torch.models.unet2d import CrossAttention, UNet2DCondition, UNetConfig
    from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion

    with pytest.raises(ValueError, match="flash_bwd"):
        CrossAttention(8, 2, flash_bwd="Merged")
    with pytest.raises(ValueError, match="flash_bwd"):
        UNet2DCondition(UNetConfig.tiny(), flash_bwd="")
    with pytest.raises(ValueError, match="flash_bwd"):
        StableDiffusion(SDConfig.tiny(), device="cpu", flash_bwd="fused")
    unet = StableDiffusion(SDConfig.tiny(), device="cpu", flash_bwd="merged").unet
    assert {m.flash_bwd for m in unet.modules() if hasattr(m, "to_q")} == {"merged"}


# -- the masked K1's plain version and the attention route ------------------------


def _eos_mask(lengths, t=77):
    """Key masks as `eos_attention_mask` makes them: the first `length` keys valid."""
    return (torch.arange(t)[None] < torch.tensor(lengths)[:, None]).int()


@pytest.mark.parametrize("s,h,d", [(64, 2, 40), (32, 2, 64), (16, 2, 80), (8, 2, 160)])
def test_masked_plain_equals_the_bias_path(s, h, d):
    """flash_attention_plain with a key mask [B, T] is the plain attention
    with the additive `expand_padding_mask` bias, fp32 within 1e-6, for eos
    masks of length 1, 9 and 77 at T = 77 and the UNets' head dims; the
    wrapper on CPU tensors runs it and launches nothing; and the key mask
    down the plain route is that bias path exactly (the CPU route is
    unchanged)."""
    g = torch.Generator().manual_seed(d)
    q = torch.randn(3, s, h, d, generator=g)
    k, v = torch.randn(3, 77, h, d, generator=g), torch.randn(3, 77, h, d, generator=g)
    mask = _eos_mask([1, 9, 77])
    want = tlayers.dot_product_attention(q, k, v, tlayers.expand_padding_mask(mask))
    torch.testing.assert_close(tfa.flash_attention_plain(q, k, v, mask), want, atol=1e-6, rtol=0)
    torch.testing.assert_close(tfa.flash_attention_plain(q, k, v, mask.bool()), want, atol=1e-6, rtol=0)
    before = (tfa.launches, tfa.launches_short)
    torch.testing.assert_close(tfa.flash_attention(q, k, v, key_mask=mask), want, atol=1e-6, rtol=0)
    assert (tfa.launches, tfa.launches_short) == before
    assert torch.equal(tlayers.dot_product_attention(q, k, v, use_flash=True, key_mask=mask), want)
    # the first key alone: each row attends to it only
    torch.testing.assert_close(tfa.flash_attention_plain(q, k, v, mask)[0], v[0, :1].expand(s, h, d), atol=1e-6,
                               rtol=0)


def test_key_mask_is_refused_where_the_kernels_take_none():
    """No key mask with lse or on the gradient route (the route sends those
    calls to the plain attention), and none of another shape."""
    q, k, v = (torch.randn(2, 8, 2, 16) for _ in range(3))
    mask = _eos_mask([3, 8], t=8)
    with pytest.raises(ValueError, match="no key mask"):
        tfa._forward(q, k, v, with_lse=True, key_mask=mask)
    with pytest.raises(ValueError, match="gradient route takes no key mask"):
        tfa.flash_attention(q.requires_grad_(), k, v, key_mask=mask)
    with pytest.raises(ValueError, match="key mask"):
        tfa.flash_attention(q.detach(), k, v, key_mask=mask[:, :5])


# single attention sites of SD-1.5 (masked cross-attention) and SDXL (none),
# as (keys, key mask), against the route with and without a gradient
ROUTE_SITES = {
    "sd15_self_4096": (4096, False), "sd15_self_256": (256, False), "sd15_self_64": (64, False),
    "sd15_cross": (77, True), "sd15_cross_unmasked": (77, False),
    "sdxl_self_1024": (1024, False), "sdxl_cross": (77, False),
}


@pytest.mark.parametrize("site", ROUTE_SITES)
@pytest.mark.parametrize("grad", [False, True])
def test_attention_route_at_the_unets_sites(site, grad):
    """On CUDA with `use_flash`: K1 for every site without a gradient (the
    cross-attention with its key mask); with one, the kernels only for
    self-attention over at least FLASH_MIN_KV keys. Without `use_flash`, on
    the CPU, or with an additive bias: the plain path."""
    keys, masked = ROUTE_SITES[site]
    route = functools.partial(tlayers.attention_route, grad=grad, keys=keys, key_mask=masked)
    want = "flash" if not grad or (keys >= tfa.FLASH_MIN_KV and not masked) else "plain"
    assert route(cuda=True, use_flash=True, bias=False) == want
    assert route(cuda=True, use_flash=False, bias=False) == "plain"
    assert route(cuda=False, use_flash=True, bias=False) == "plain"
    assert route(cuda=True, use_flash=True, bias=True) == "plain"


@functools.lru_cache(maxsize=None)
def _unet_sites(model: str) -> tuple:
    """(keys, key mask) of every attention call of one full-size UNet forward
    (SD-1.5 at 512 px with its key mask or without, SDXL at 1024 px), run on
    the meta device with the attention and GEGLU recorded, not computed."""
    from fairdiff_torch.models import unet2d

    cfg, n = {"sd15": (unet2d.UNetConfig.sd15(), 64), "sd15_unmasked": (unet2d.UNetConfig.sd15(), 64),
              "sdxl": (unet2d.UNetConfig.sdxl(), 128)}[model]
    sites = []

    def recording(q, k, v, bias=None, flash_bwd="split", use_flash=False, key_mask=None):
        assert use_flash and bias is None
        sites.append((k.shape[1], key_mask is not None))
        return torch.empty_like(q)

    saved = unet2d.dot_product_attention, unet2d.geglu
    unet2d.dot_product_attention = recording
    unet2d.geglu = lambda x, w, b: x.new_empty(*x.shape[:-1], w.shape[0] // 2)
    try:
        with torch.device("meta"), torch.no_grad():
            unet = unet2d.UNet2DCondition(cfg)
            mask = torch.ones(2, 77, dtype=torch.int32) if model == "sd15" else None
            added = {"text_embeds": torch.empty(2, 1280), "time_ids": torch.empty(2, 6)} if model == "sdxl" else None
            unet(torch.empty(2, n, n, 4), torch.tensor([500, 500]), torch.empty(2, 77, cfg.cross_attention_dim), mask,
                 added_cond=added)
    finally:
        unet2d.dot_product_attention, unet2d.geglu = saved
    return tuple(sites)


@pytest.mark.parametrize("model,grad,want", [
    ("sd15", False, (32, 22, 16)), ("sd15", True, (10, 0, 0)),
    ("sd15_unmasked", False, (32, 22, 0)), ("sd15_unmasked", True, (10, 0, 0)),
    ("sdxl", False, (140, 70, 0)), ("sdxl", True, (70, 0, 0)),
])
def test_attention_route_over_a_unet_call(model, grad, want):
    """Over every attention site of a UNet call, the K1 launches the route
    gives on CUDA: (K1 launches, of them short-key or masked, of them
    masked). Without a gradient SD-1.5 at 512 px runs 10 + 22 = 32 (its 16
    cross-attentions and the 6 self-attentions over 256 and 64 tokens join
    the 10 over 4096 and 1024) and SDXL at 1024 px 70 + 70 = 140; with a
    gradient the kernels keep the long-key self-attention alone (10 and
    70), as before the route took the short keys. Without `use_flash`, none."""
    sites = _unet_sites(model)
    assert len(sites) == {"sdxl": 140}.get(model, 32)
    routes = [(tlayers.attention_route(cuda=True, use_flash=True, grad=grad, keys=t, bias=False, key_mask=m), t, m)
              for t, m in sites]
    flash = [(t, m) for r, t, m in routes if r == "flash"]
    assert (len(flash), sum(t < tfa.FLASH_MIN_KV or m for t, m in flash), sum(m for _, m in flash)) == want
    assert all(tlayers.attention_route(cuda=True, use_flash=False, grad=grad, keys=t, bias=False, key_mask=m)
               == "plain" for t, m in sites)
