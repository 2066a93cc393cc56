"""fairdiff_torch's face-recognition backbones and builder against the JAX
package's: IResNet (tiny and iresnet18 at 112 px) with the JAX parameters
carried over, `convert_iresnet` on an opensphere-layout state dict, the
backbone registry, `fill_config` and the shipped recipes.

Tolerances: IResNet features within rel L2 1e-5, and each element within
1e-4 x the features' rms (fp32 convolutions summed in other orders through
up to 18 layers; iresnet18 reads 2.3e-6 rel L2 and 1.1e-5 x rms);
`convert_iresnet` exactly equal; the config copies byte-equal.
"""

import dataclasses
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fairdiff.facerec import builder as jbuilder
from fairdiff.facerec import datasets as jdatasets
from fairdiff.facerec.trainer import FaceRecConfig as JaxFaceRecConfig
from fairdiff.models import iresnet as jiresnet
from fairdiff_torch.facerec import builder as tbuilder
from fairdiff_torch.facerec import datasets as tdatasets
from fairdiff_torch.facerec.trainer import FaceRecConfig
from fairdiff_torch.io.from_jax import jax_tree_from_module, load_jax_params
from fairdiff_torch.models import iresnet as tiresnet
from fairdiff_torch.tools.train_facerec import trainer_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
JAX_CONFIGS = REPO / "fairdiff" / "configs" / "facerec"
RECIPES = sorted(p.name for p in JAX_CONFIGS.glob("*.yml") if p.name != "base.yml")


def _perturbed(tree, rng):
    """Every leaf of a JAX IResNet tree moved off its init, so BN statistics,
    scales and PReLU slopes all matter."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k == "var":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("mean", "bias"):
            out[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        elif k == "scale":
            out[k] = (1 + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
        elif k == "alpha":
            out[k] = rng.uniform(0.0, 0.5, v.shape).astype(np.float32)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("variant,size", [("tiny", 32), ("iresnet18", 112)])
def test_iresnet_matches_jax(variant, size):
    cfg = getattr(jiresnet.IResNetConfig, variant)()
    net = jiresnet.IResNet(cfg)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    params = _perturbed(net.init(jax.random.key(0), jnp.asarray(x))["params"], rng)
    want = np.asarray(net.apply({"params": params}, jnp.asarray(x)))

    tnet = load_jax_params(tiresnet.IResNet(getattr(tiresnet.IResNetConfig, variant)()), params)
    with torch.no_grad():
        got = tnet(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (2, cfg.out_channel)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    rms = np.sqrt((want**2).mean())
    err = np.abs(got - want).max() / rms
    assert rel <= 1e-5, rel
    assert err <= 1e-4, err
    # the inverse map writes the same tree back
    back = jax_tree_from_module(tnet)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def _opensphere_state_dict(cfg, rng):
    """An opensphere IResNet state dict (torch layout) of random numpy arrays."""
    widths = cfg.widths
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = rng.normal(size=(cout, cin, k, k)).astype(np.float32)

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{name}.{leaf}"] = rng.normal(size=(c,)).astype(np.float32)

    conv("conv1", widths[0], 3, 3)
    bn("bn1", widths[0])
    sd["prelu.weight"] = rng.normal(size=(widths[0],)).astype(np.float32)
    ch = widths[0]
    for li, (n, w) in enumerate(zip(cfg.layers, widths), 1):
        for bi in range(n):
            p = f"layer{li}.{bi}"
            bn(f"{p}.bn1", ch)
            conv(f"{p}.conv1", w, ch, 3)
            bn(f"{p}.bn2", w)
            sd[f"{p}.prelu.weight"] = rng.normal(size=(w,)).astype(np.float32)
            conv(f"{p}.conv2", w, w, 3)
            bn(f"{p}.bn3", w)
            if bi == 0:
                conv(f"{p}.downsample.0", w, ch, 1)
                bn(f"{p}.downsample.1", w)
            ch = w
    bn("bn2", widths[3])
    side = cfg.in_size // 16
    sd["fc.weight"] = rng.normal(size=(cfg.out_channel, widths[3] * side * side)).astype(np.float32)
    sd["fc.bias"] = rng.normal(size=(cfg.out_channel,)).astype(np.float32)
    bn("features", cfg.out_channel)
    return sd


@pytest.mark.parametrize("variant", ["tiny", "iresnet18"])
def test_convert_iresnet_matches_jax(variant):
    cfg = getattr(tiresnet.IResNetConfig, variant)()
    sd = _opensphere_state_dict(cfg, np.random.default_rng(1))
    got = tiresnet.convert_iresnet(sd, cfg)
    want = jiresnet.convert_iresnet(sd, getattr(jiresnet.IResNetConfig, variant)())
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # and the converted tree loads into the port's module
    load_jax_params(tiresnet.IResNet(cfg), got)


def test_backbone_registry_and_builders(tmp_path):
    assert list(tbuilder.BACKBONES) == list(jbuilder.BACKBONES)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    for spec in ({"type": "sfnet4", "out_channel": 64, "in_size": 32},
                 {"type": "sfnet4_deprecated", "out_channel": 64, "in_size": 32, "layers": [0, 1, 0, 0]},
                 {"type": "iresnet18", "out_channel": 32, "in_size": 32, "in_channel": 3}):
        jnet = jbuilder.build_backbone(spec)
        params = jnet.init(jax.random.key(0), jnp.asarray(x))["params"]
        want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
        tnet = load_jax_params(tbuilder.build_backbone(spec), params)
        with torch.no_grad():
            got = tnet(torch.tensor(x)).numpy()
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want), spec
    assert tbuilder.build_backbone({"type": "sfnet4_deprecated"}).config.pre_act_residual

    head = {"type": "SphereFacePlus", "s": 30.0, "m": 1.5, "lambda_MHE": 0.5, "feat_dim": 64, "num_class": 10}
    fn, kwargs = tbuilder.build_head(head)
    jfn, jkwargs = jbuilder.build_head(head)
    assert fn.__name__ == jfn.__name__ and kwargs == jkwargs == {"s": 30.0, "m": 1.5, "lambda_mhe": 0.5}

    (tmp_path / "base.yml").write_text("type: sfnet20\nout_channel: 512\nextra: {a: 1, b: 2}\n")
    cfg = {"model": {"backbone": {"base": "base.yml", "out_channel": 256, "extra": {"b": 3}}}, "x": 1}
    assert tbuilder.fill_config(cfg, tmp_path) == jbuilder.fill_config(cfg, str(tmp_path))
    assert tbuilder.fill_config(cfg, tmp_path)["model"]["backbone"] == {
        "type": "sfnet20", "out_channel": 256, "extra": {"a": 1, "b": 3}}
    assert tbuilder.deep_merge({"a": {"b": 1, "c": 2}}, {"a": {"b": 9}}) == {"a": {"b": 9, "c": 2}}


def test_config_copies_are_byte_equal():
    names = sorted(p.name for p in tbuilder.CONFIG_DIR.glob("*.yml"))
    assert names == sorted(p.name for p in JAX_CONFIGS.glob("*.yml")) and len(names) == 24
    for name in names:
        assert (tbuilder.CONFIG_DIR / name).read_bytes() == (JAX_CONFIGS / name).read_bytes(), name


@pytest.mark.parametrize("name", RECIPES)
def test_shipped_recipe_builds_in_the_port(name):
    path = tbuilder.CONFIG_DIR / name
    cfg = tbuilder.fill_config(yaml.safe_load(path.read_text()), base_dir=path.parent)
    assert cfg == jbuilder.fill_config(yaml.safe_load((JAX_CONFIGS / name).read_text()),
                                       base_dir=JAX_CONFIGS)
    bb = cfg["model"]["backbone"]
    with torch.device("meta"):
        net = tbuilder.build_backbone(bb)
        out = net(torch.empty(2, bb.get("in_size", 112), bb.get("in_size", 112), 3))
    assert tuple(out.shape) == (2, bb["out_channel"])
    if "head" in cfg["model"]:
        fn, kwargs = tbuilder.build_head(cfg["model"]["head"])
        assert not set(kwargs) - set(inspect.signature(fn).parameters)
        tcfg = trainer_config(cfg, num_classes=8631)
        assert isinstance(tcfg, FaceRecConfig)
        assert tcfg.lr_decay_rate == cfg["trainer"]["lr_decay_gamma"] == 0.1
        assert tcfg.lr == 0.1 and tcfg.feat_dim == bb["out_channel"]
        assert tcfg.head == cfg["model"]["head"]["type"].lower()
    for section in ("train", "val"):
        entries = cfg.get("data", {}).get(section, [])
        for entry in [entries] if isinstance(entries, dict) else entries:
            ds_cfg = dict(entry["dataset"])
            kind = ds_cfg.pop("type")
            ds_cfg.pop("name", None)
            inspect.signature(getattr(tdatasets, kind)).bind(**ds_cfg)


@pytest.mark.parametrize("name", [n for n in RECIPES if not n.startswith("test_")])
def test_jax_trainer_config_rejects_the_shipped_recipes(name):
    """The fault the port does not copy: every shipped training recipe
    inherits `lr_decay_gamma` from base.yml, which the JAX package's
    FaceRecConfig does not take (so `fairdiff.tools.train_facerec` raises on
    them); the port maps it onto `lr_decay_rate`."""
    cfg = jbuilder.fill_config(yaml.safe_load((JAX_CONFIGS / name).read_text()),
                               base_dir=JAX_CONFIGS)
    tcfg = dict(cfg["trainer"])
    tcfg["lr_decay_steps"] = tuple(tcfg["lr_decay_steps"])
    with pytest.raises(TypeError, match="lr_decay_gamma"):
        JaxFaceRecConfig(**tcfg)
    assert {f.name for f in dataclasses.fields(FaceRecConfig)} == {f.name for f in dataclasses.fields(JaxFaceRecConfig)}
    # every dataset kwarg the recipes use is taken by both packages' classes
    for entry in [cfg["data"]["train"]]:
        ds_cfg = dict(entry["dataset"])
        kind = ds_cfg.pop("type")
        inspect.signature(getattr(jdatasets, kind)).bind(**ds_cfg)
