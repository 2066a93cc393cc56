"""fairdiff_torch models against the JAX modules at the tiny configs.

The JAX modules' own parameter trees (shapes from `init`, traced with
`jax.eval_shape`; values drawn from one numpy seed, including non-zero
biases and norm scales) are carried into the port by
`fairdiff_torch.io.from_jax`. Both sides run float32 on the CPU; the JAX
side at "highest" matmul precision (tests/conftest.py). Tolerances are
relative to the output's scale and state the summation-order noise of
fp32 through the model's depth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from fairdiff.adapters import lora as jlora
from fairdiff.models.autoencoder_kl import AutoencoderKL as JVAE
from fairdiff.models.clip_text import CLIPTextModel as JCLIP
from fairdiff.models.unet2d import UNet2DCondition as JUNet
from fairdiff.sampling.pipeline import SDConfig as JSDConfig
from fairdiff_torch.adapters import lora as tlora_lib
from fairdiff_torch.io.from_jax import adapters_from_jax, load_jax_params, state_dict_from_jax, tree_from_npz
from fairdiff_torch.models.autoencoder_kl import AutoencoderKL, VAEConfig
from fairdiff_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from fairdiff_torch.models.unet2d import UNet2DCondition, UNetConfig
from fairdiff_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)


def random_tree(shapes, seed: int):
    """numpy values for a JAX parameter-shape tree: kernels N(0, 1/fan_in),
    biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2), embeddings N(0, 0.3^2)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            v = rng.normal(size=shape) * np.prod(shape[:-1]) ** -0.5
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name in ("embedding", "position_embedding"):
            v = 0.3 * rng.normal(size=shape)
        else:
            v = 0.1 * rng.normal(size=shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def rel_err(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _to_np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


TEXT = JSDConfig.tiny().text


def _clip_inputs():
    rng = np.random.default_rng(5)
    ids = rng.integers(1, TEXT.vocab_size - 1, size=(2, 12)).astype(np.int32)
    ids[0, 6:] = TEXT.eos_token_id  # padded with eos, as CLIP pads
    ids[1, -1] = TEXT.eos_token_id
    mask = (np.arange(12)[None] <= np.array([[6], [11]])).astype(np.int32)
    return ids, mask


def _clip_pair():
    jm = JCLIP(TEXT)
    ids, mask = _clip_inputs()
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(ids))["params"]
    params = random_tree(shapes, seed=0)
    tm = load_jax_params(CLIPTextModel(CLIPTextConfig(**vars(TEXT))), params).eval()
    return jm, params, tm


def test_clip_text_matches_jax():
    jm, params, tm = _clip_pair()
    ids, mask = _clip_inputs()
    want = jax.jit(lambda p, i, m: jm.apply({"params": p}, i, attention_mask=m))(
        params, jnp.asarray(ids), jnp.asarray(mask)
    )
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    # 2 layers at width 32: fp32 noise well below 1e-5 relative
    for key in ("last_hidden_state", "pooler_output"):
        assert rel_err(_to_np(got[key]), np.asarray(want[key])) < 1e-5, key


def test_clip_text_inputs_embeds_matches_jax():
    jm, params, tm = _clip_pair()
    ids, _ = _clip_inputs()
    embeds = np.random.default_rng(6).normal(size=(2, 12, TEXT.hidden_size)).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(ids), inputs_embeds=jnp.asarray(embeds))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), inputs_embeds=torch.from_numpy(embeds))
    assert rel_err(_to_np(got["last_hidden_state"]), np.asarray(want["last_hidden_state"])) < 1e-5


def test_unet_matches_jax():
    cfg = UNetConfig.tiny()
    jm = JUNet(JSDConfig.tiny().unet)
    rng = np.random.default_rng(7)
    lat = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    t = np.array([999, 17], np.int32)
    ctx = rng.normal(size=(2, 5, cfg.cross_attention_dim)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    shapes = jax.eval_shape(
        jm.init, jax.random.key(0), jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx)
    )["params"]
    params = random_tree(shapes, seed=1)
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(
        params, *map(jnp.asarray, (lat, t, ctx, mask))
    )
    tm = load_jax_params(UNet2DCondition(cfg), params).eval()
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (lat, t, ctx, mask)))
    assert got.shape == (2, 8, 8, 4)
    # ~40 layers at widths 32-64 in fp32: 1e-4 relative L2 covers the
    # summation-order noise (measured ~1e-6)
    assert rel_err(_to_np(got), np.asarray(want)) < 1e-4


def test_unet_context_vjp_with_remat_matches_jax():
    """The gradient of <w, eps> with respect to the context (the phase-4
    pair VJP's path to the text encoder) and to a UNet LoRA on every
    attention projection (non-zero `up`; merged by `apply_lora` and passed
    to the remat blocks as `weights`, as `StableDiffusion.unet_eps` does)
    through the remat UNet, against jax.grad through the JAX module built
    with remat=True and the same LoRA. Tolerance as the forward, 1e-4
    relative L2, for the context and for each LoRA leaf."""
    cfg = UNetConfig.tiny()
    jm = JUNet(JSDConfig.tiny().unet, remat=True)
    rng = np.random.default_rng(10)
    lat = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    t = np.array([500, 500], np.int32)
    ctx = rng.normal(size=(2, 5, cfg.cross_attention_dim)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    w = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    shapes = jax.eval_shape(
        jm.init, jax.random.key(0), jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx)
    )["params"]
    params = random_tree(shapes, seed=4)
    lora = jlora.init_lora(params, jlora.unet_attention_targets, 2, jax.random.key(3))
    lrng = np.random.default_rng(11)
    lora = jax.tree_util.tree_map_with_path(
        lambda path, x: (0.1 * lrng.normal(size=x.shape)).astype(np.float32) if path[-1].key == "up"
        else np.asarray(x), lora)

    def jloss(c, lo):
        eps = jm.apply({"params": jlora.apply_lora(params, lo)}, jnp.asarray(lat), jnp.asarray(t), c,
                       jnp.asarray(mask))
        return jnp.sum(eps * w)

    want_ctx, want_lora = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(ctx), jax.tree.map(jnp.asarray, lora))
    tm = load_jax_params(UNet2DCondition(cfg, remat=True), params).requires_grad_(False)
    tctx = torch.from_numpy(ctx).requires_grad_()
    tlora = tree_map(lambda x: x.requires_grad_(), adapters_from_jax(lora))
    weights = tlora_lib.apply_lora(tm, tlora)
    out = functional_call(tm, weights, (torch.from_numpy(lat), torch.from_numpy(t), tctx, torch.from_numpy(mask)),
                          {"weights": weights})
    (out * torch.from_numpy(w)).sum().backward()
    assert rel_err(tctx.grad.numpy(), np.asarray(want_ctx)) < 1e-4
    got, want = tree_leaves(tlora), jax.tree_util.tree_leaves(want_lora)
    assert len(got) == len(want) == 16 * 2 * 4 * 2  # 16 blocks x 2 attentions x q, k, v, out x down, up
    for g, j in zip(got, want):
        if not np.any(j):  # the mid block's self-attention sees one token: its q and k get no gradient
            assert not g.grad.any()
        else:
            assert rel_err(g.grad.numpy(), np.asarray(j)) < 1e-4


@pytest.fixture(scope="module")
def vae_pair():
    jm = JVAE(JSDConfig.tiny().vae)
    img = np.random.default_rng(8).uniform(-1, 1, size=(1, 32, 32, 3)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(img))["params"]
    params = random_tree(shapes, seed=2)
    tm = load_jax_params(AutoencoderKL(VAEConfig.tiny()), params).eval()
    return jm, params, tm, img


def test_vae_decode_matches_jax(vae_pair):
    jm, params, tm, _ = vae_pair
    z = np.random.default_rng(9).normal(size=(1, 4, 4, 4)).astype(np.float32)
    want = jax.jit(lambda p, z: jm.apply({"params": p}, z, method=jm.decode))(params, jnp.asarray(z))
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(z))
    assert got.shape == (1, 32, 32, 3)
    assert rel_err(_to_np(got), np.asarray(want)) < 1e-4  # as for the UNet


def test_vae_encode_matches_jax(vae_pair):
    jm, params, tm, img = vae_pair
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x, method=jm.encode))(params, jnp.asarray(img))
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(img))
    for g, w in zip(got, want):
        assert g.shape == (1, 4, 4, 4)
        assert rel_err(_to_np(g), np.asarray(w)) < 1e-4


def test_npz_tree_roundtrip_and_layout(tmp_path):
    """A tree saved flat with '/'-joined keys loads to the same state dict;
    Dense kernels transpose and HWIO conv kernels become OIHW."""
    tree = {
        "a": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3), "bias": np.ones(3, np.float32)},
        "c": {"kernel": np.arange(2 * 2 * 3 * 5, dtype=np.float32).reshape(2, 2, 3, 5)},
        "n": {"scale": np.ones(4, np.float32)},
    }
    np.savez(tmp_path / "t.npz", **{"a/kernel": tree["a"]["kernel"], "a/bias": tree["a"]["bias"],
                                    "c/kernel": tree["c"]["kernel"], "n/scale": tree["n"]["scale"]})
    sd = state_dict_from_jax(tree_from_npz(tmp_path / "t.npz"))
    assert set(sd) == {"a.weight", "a.bias", "c.weight", "n.weight"}
    np.testing.assert_array_equal(sd["a.weight"].numpy(), tree["a"]["kernel"].T)
    np.testing.assert_array_equal(sd["c.weight"].numpy(), tree["c"]["kernel"].transpose(3, 2, 0, 1))
