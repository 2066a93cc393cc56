"""The UNet LoRA under remat: `StableDiffusion.unet_eps` with merged LoRA
weights and the UNet rematerialised per block, against the JAX pipeline's
`unet_eps` with `remat=True` and the same LoRA, against itself with remat
off, and one exp-1 `train_step` with `train_unet=True` against the JAX
trainer. Float32 on the CPU at `SDConfig.tiny()`; each tolerance is stated
where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairdiff.adapters import lora as jlora
from fairdiff.sampling import pipeline as jpipe
from fairdiff_torch.adapters import lora as tlora
from fairdiff_torch.io.from_jax import adapters_from_jax
from fairdiff_torch.sampling import pipeline as tpipe
from fairdiff_torch.utils.tree import tree_leaves, tree_map
from test_torch_models import random_tree, rel_err
from test_torch_trainer import CFG, assert_steps_match_jax

torch.set_num_threads(1)

GS = 7.5  # guidance scale of the pair surrogate


@pytest.fixture(scope="module")
def pair():
    """Tiny SD weights, a rank-2 UNet LoRA with non-zero `up` (so `down`
    gets a gradient) and one pair VJP's inputs: 2 lanes CFG-doubled, a
    5-token context with a padded key mask, a cotangent."""
    jsd = jpipe.StableDiffusion(jpipe.SDConfig.tiny(), remat=True)
    params = random_tree(jax.eval_shape(jsd.init_params, jax.random.key(0)), seed=5)
    lora = jlora.init_lora(params["unet"], jlora.unet_attention_targets, 2, jax.random.key(2))
    rng = np.random.default_rng(12)
    lora = jax.tree_util.tree_map_with_path(
        lambda path, x: (0.1 * rng.normal(size=x.shape)).astype(np.float32) if path[-1].key == "up"
        else np.asarray(x), lora)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(4, 5, 32)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0]] * 2 + [[1, 1, 1, 1, 0]] * 2, np.int32)
    cot = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    return jsd, params, lora, (x, ctx, mask, cot)


def _port_grads(params, lora, inputs, remat: bool) -> list[np.ndarray]:
    """[d/d context, d/d each LoRA leaf] of <cot, guided eps> through the
    port's `unet_eps`."""
    sd = tpipe.StableDiffusion(tpipe.SDConfig.tiny(), device="cpu", remat=remat).load_jax(params)
    tl = tree_map(lambda t: t.requires_grad_(), adapters_from_jax(lora))
    x, ctx, mask, cot = (torch.from_numpy(a) for a in inputs)
    tctx = ctx.clone().requires_grad_()
    eps2 = sd.unet_eps(torch.cat([x, x]), 500, tctx, mask, unet_weights=tlora.apply_lora(sd.unet, tl)).float()
    eps_u, eps_c = eps2.chunk(2)
    grads = torch.autograd.grad(((eps_u + GS * (eps_c - eps_u)) * cot).sum(), [tctx, *tree_leaves(tl)])
    return [g.numpy() for g in grads]


def test_pair_vjp_lora_grads_with_remat_match_jax(pair):
    """The pair VJP's context and UNet-LoRA gradients with remat on, against
    jax.grad through the JAX `unet_eps` of the remat UNet with the same LoRA:
    1e-4 relative L2 per leaf (fp32 through the tiny UNet, as the forward's
    parity test); the leaves JAX gives no gradient (q and k of the mid
    block's self-attention over one token) get none here either."""
    jsd, params, lora, inputs = pair
    x, ctx, mask, cot = (jnp.asarray(a) for a in inputs)

    def surrogate(lo, c):
        eps2 = jsd.unet_eps(params, jnp.concatenate([x, x]), jnp.int32(500), c, mask, unet_lora=lo).astype(jnp.float32)
        eps_u, eps_c = jnp.split(eps2, 2)
        return jnp.sum((eps_u + GS * (eps_c - eps_u)) * cot)

    want_lora, want_ctx = jax.jit(jax.grad(surrogate, argnums=(0, 1)))(jax.tree.map(jnp.asarray, lora), ctx)
    got = _port_grads(params, lora, inputs, remat=True)
    want = [np.asarray(want_ctx)] + [np.asarray(j) for j in jax.tree_util.tree_leaves(want_lora)]
    assert len(got) == len(want) == 1 + 16 * 2 * 4 * 2
    for g, j in zip(got, want):
        if not np.any(j):
            assert not np.any(g)
        else:
            assert rel_err(g, j) < 1e-4


def test_remat_on_matches_off(pair):
    """The recompute runs each block with the merged weights its forward
    used, so remat on and off give the same gradients: 1e-6 relative L2 per
    leaf (they are bit-equal on the CPU)."""
    _, params, lora, inputs = pair
    on = _port_grads(params, lora, inputs, remat=True)
    off = _port_grads(params, lora, inputs, remat=False)
    assert any(np.any(g) for g in on[1:])
    for a, b in zip(on, off):
        assert np.array_equal(a, b) or rel_err(a, b) <= 1e-6


def test_unet_eps_takes_lora_weights_under_remat():
    """`unet_eps` with UNet weights, remat on and autograd on runs (it
    raised ValueError before the blocks took the weights) and its gradient
    reaches a LoRA `down` leaf."""
    sd = tpipe.StableDiffusion(tpipe.SDConfig.tiny(), device="cpu", remat=True).init_random(0)
    g = torch.Generator().manual_seed(0)
    lora = tlora.init_lora(sd.unet, tlora.unet_attention_targets, 2, g)
    lora = tree_map(lambda t: (t + 0.1 * torch.randn(t.shape, generator=g)).requires_grad_(), lora)
    eps = sd.unet_eps(torch.randn(2, 8, 8, 4, generator=g), 10, torch.randn(2, 5, 32, generator=g),
                      unet_weights=tlora.apply_lora(sd.unet, lora))
    eps.square().sum().backward()
    down = lora["down_0_attn_0"]["transformer_blocks_0"]["attn1"]["to_q"]["down"]
    assert down.grad is not None and down.grad.abs().max() > 0


def test_unet_lora_train_step_with_remat_matches_jax():
    """One exp-1 step training the UNet and text-encoder LoRAs with both
    UNets rematerialised per block, against the JAX trainer's step, held to
    `assert_steps_match_jax`'s limits (per-leaf grads 2e-4 relative L2,
    adapters and EMA 1e-7 + 1e-6 relative plus the update difference the two
    gradients explain, logs 1e-4)."""
    assert_steps_match_jax(dict(CFG, train_unet=True), remat=True, adam_slack=True)
