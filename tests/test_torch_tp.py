"""fairdiff_torch.parallel.tp against fairdiff.parallel.tp.

- the placement of every parameter of a tiny SD: the port's specs, mapped
  through `io.from_jax` onto the JAX tree, equal `sd_param_specs`' (exact);
- `validate_heads` raises where the JAX function does;
- the tiny UNet's and text encoder's forwards split over data=2 x model=2
  (four gloo processes) within 1e-5 of the JAX forwards on the JAX
  package's `shard_sd_params` placement over a 2 x 2 mesh, with the plain
  attention and with the flash route (the wrapper's plain version on the
  CPU; JAX's Pallas kernel in interpret mode), both at the JAX tests'
  threshold of one key;
- shard_sd_modules' local weights, heads and LoRA slices.
fp32. (The split trainer step is in test_torch_parallel.py.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.sharding import NamedSharding, PartitionSpec as P

import fairdiff.models.layers as jlayers
from fairdiff.parallel import MeshConfig as JaxMeshConfig
from fairdiff.parallel import create_mesh as jax_create_mesh
from fairdiff.parallel.tp import sd_param_specs as jax_sd_param_specs
from fairdiff.parallel.tp import shard_sd_params
from fairdiff.parallel.tp import validate_heads as jax_validate_heads
from fairdiff.sampling import pipeline as jpipe
from fairdiff_torch.io.from_jax import state_dict_from_jax
from fairdiff_torch.parallel import tp
from fairdiff_torch.parallel.launch import spawn
from fairdiff_torch.sampling import pipeline as tpipe
from test_torch_models import random_tree

torch.set_num_threads(1)

CODES = {"replicated": 0, "col": 1, "row": 2}


def _jax_code(spec: P, leaf: str) -> int:
    if spec == P():
        return CODES["replicated"]
    if spec[0] == "model" and (len(spec) > 1 or leaf == "kernel"):
        return CODES["row"]
    return CODES["col"]  # P(..., "model") on a kernel, P("model") on a bias


@pytest.fixture(scope="module")
def tiny():
    jsd = jpipe.StableDiffusion(jpipe.SDConfig.tiny())
    params = random_tree(jax.eval_shape(jsd.init_params, jax.random.key(0)), seed=3)
    return jsd, jax.device_get(params)


def test_param_specs_match_jax(tiny):
    jsd, params = tiny
    specs = jax_sd_param_specs(params, jsd.config)
    tsd = tpipe.StableDiffusion(tpipe.SDConfig.tiny(), device="cpu")
    got = tp.sd_param_specs(tsd.models())
    for model, tree in params.items():
        # each JAX leaf filled with its placement's code, carried onto the
        # port's names by the weight converter
        coded = jax.tree_util.tree_map_with_path(
            lambda path, x, s: np.full(np.shape(x), _jax_code(s, path[-1].key), np.float32),
            tree, specs[model], is_leaf=lambda x: isinstance(x, P))
        want = {name: int(t.reshape(-1)[0]) for name, t in state_dict_from_jax(coded).items()}
        assert set(want) == set(got[model]), model
        assert {k: CODES[v] for k, v in got[model].items()} == want, model
    assert set(got["unet"].values()) == set(got["text_encoder"].values()) == set(CODES)
    assert set(got["vae"].values()) == {"replicated"}


@pytest.mark.parametrize("preset", ["sd15", "tiny"])
@pytest.mark.parametrize("model", [1, 2, 3, 4, 5, 6, 8, 12])
def test_validate_heads_matches_jax(preset, model):
    jcfg = getattr(jpipe.SDConfig, preset)()
    tcfg = getattr(tpipe.SDConfig, preset)()
    want = got = None
    try:
        jax_validate_heads(jcfg, model)
    except ValueError as e:
        want = str(e)
    try:
        tp.validate_heads(tcfg, model)
    except ValueError as e:
        got = str(e)
    assert got == want


def _jax_forwards(jsd, params, x, t, ctx, ids):
    """The JAX UNet and text encoder on `shard_sd_params`' placement over a
    2 x 2 mesh, batch sharded over "data"."""
    mesh = jax_create_mesh(JaxMeshConfig(data=2, model=2), devices=jax.devices()[:4])
    placed = shard_sd_params(mesh, params, jsd.config)
    batch = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("data")))
    eps = jax.jit(lambda p, x, t, c: jsd.unet.apply({"params": p}, x, t, c))(
        placed["unet"], batch(x), batch(t), batch(ctx))
    hidden = jax.jit(lambda p, i: jsd.text_encoder.apply({"params": p}, i))(
        placed["text_encoder"], batch(ids))["last_hidden_state"]
    return np.asarray(eps), np.asarray(hidden)


@pytest.mark.parametrize("flash", [False, True])
def test_tp_forwards_match_jax_shard_sd_params(tmp_path, tiny, monkeypatch, flash):
    jsd, params = tiny
    if flash:
        monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        monkeypatch.setattr(jlayers, "FLASH_MIN_KV", 1)
        jsd = jpipe.StableDiffusion(jpipe.SDConfig.tiny(), use_flash=True)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 8, 8, 4)).astype(np.float32)
    t = np.full((4,), 7, np.int32)
    ctx = rng.normal(size=(4, 4, 32)).astype(np.float32)
    ids = np.array([[0, 5, 6, 63], [0, 7, 63, 63], [0, 9, 8, 63], [0, 63, 63, 63]], np.int32)
    want_eps, want_hidden = _jax_forwards(jsd, params, x, t, ctx, ids)
    out = spawn("torch_ranks:sd_forwards", 4, backend="gloo", workdir=tmp_path, timeout=240, device="cpu",
                kwargs=dict(data=2, model=2, params=params, x=x, t=t, ctx=ctx, ids=ids, flash=flash))
    assert all(r["heads"] == 1 for r in out)  # the tiny UNet's 2 heads over 2 model ranks
    for r in (0, 1):  # the two model ranks of each data rank hold the same rows
        torch.testing.assert_close(out[2 * r]["eps"], out[2 * r + 1]["eps"], rtol=0, atol=0)
    eps = torch.cat([out[0]["eps"], out[2]["eps"]]).numpy()
    hidden = torch.cat([out[0]["hidden"], out[2]["hidden"]]).numpy()
    np.testing.assert_allclose(eps, want_eps, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hidden, want_hidden, rtol=1e-5, atol=1e-5)


class _Group:
    """A stand-in for a one-rank group: these checks make no collective."""


def test_shard_module_slices_weights_heads_and_lora():
    from fairdiff_torch.adapters import lora as lora_lib

    tsd = tpipe.StableDiffusion(tpipe.SDConfig.tiny(), device="cpu").init_random(0)
    full = {k: v.clone() for k, v in tsd.unet.state_dict().items()}
    g = torch.Generator().manual_seed(0)
    lora = lora_lib.init_lora(tsd.unet, lora_lib.unet_attention_targets, 2, g)
    lora = jax.tree_util.tree_map(lambda x: torch.randn(x.shape, generator=g), lora)
    deltas = lora_lib.lora_deltas(tsd.unet, lora)
    tp._shard_module(tsd.unet, tp._UNET_RULES, _Group(), 2, 1)
    attn = tsd.unet.mid_attn_0.transformer_blocks_0.attn2
    assert attn.heads == 1 and isinstance(attn.to_k, tp.ColumnParallelLinear)
    assert isinstance(attn.to_out, tp.RowParallelLinear)
    local = tsd.unet.state_dict()
    assert set(local) == set(full)
    name = "mid_attn_0.transformer_blocks_0.attn2"
    assert torch.equal(local[f"{name}.to_k.weight"], full[f"{name}.to_k.weight"][32:])
    assert torch.equal(local[f"{name}.to_out.weight"], full[f"{name}.to_out.weight"][:, 32:])
    assert torch.equal(local[f"{name}.to_out.bias"], full[f"{name}.to_out.bias"])
    # a LoRA made after the split is full-size, and each rank merges its slice
    again = lora_lib.init_lora(tsd.unet, lora_lib.unet_attention_targets, 2, torch.Generator())
    assert jax.tree_util.tree_map(lambda x: x.shape, again) == jax.tree_util.tree_map(lambda x: x.shape, lora)
    local_deltas = lora_lib.lora_deltas(tsd.unet, lora)
    torch.testing.assert_close(local_deltas[f"{name}.to_k.weight"], deltas[f"{name}.to_k.weight"][32:])
    torch.testing.assert_close(local_deltas[f"{name}.to_out.weight"], deltas[f"{name}.to_out.weight"][:, 32:])
