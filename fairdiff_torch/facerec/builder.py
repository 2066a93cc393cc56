"""Config-driven construction for the face-recognition subsystem
(counterpart of fairdiff/facerec/builder.py).

opensphere builds everything by reflection from hierarchical YAML with
`base`-block inheritance (opensphere/builder.py:16-40 build_from_cfg,
opensphere/utils.py:32-52 fill_config). Here, as in the JAX package, an
explicit registry replaces module-path reflection, and a recursive dict
merge gives base-inheritance. The shipped recipes are in
`fairdiff_torch/configs/facerec/`, byte-for-byte copies of the JAX
package's.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable

import yaml

from fairdiff_torch.fairness import margin_heads
from fairdiff_torch.models.iresnet import IResNet, IResNetConfig
from fairdiff_torch.models.sfnet import SFNet, SFNetConfig

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs" / "facerec"
_SFNETS = ("sfnet4", "sfnet10", "sfnet20", "sfnet36", "sfnet64")


def _sfnet(variant: str) -> Callable[..., SFNet]:
    def make(**kw):
        return SFNet(dataclasses.replace(SFNetConfig.for_variant(variant), **kw))

    return make


def _iresnet(variant: str) -> Callable[..., IResNet]:
    def make(**kw):
        return IResNet(dataclasses.replace(getattr(IResNetConfig, variant)(), **kw))

    return make


BACKBONES: dict[str, Callable[..., Any]] = {
    **{v: _sfnet(v) for v in _SFNETS},
    # legacy pre-act-residual variants (sfnet_deprecated.py)
    **{f"{v}_deprecated": _sfnet(f"{v}_deprecated") for v in _SFNETS},
    **{v: _iresnet(v) for v in ("iresnet18", "iresnet34", "iresnet50", "iresnet100")},
}


def deep_merge(base: dict, override: dict) -> dict:
    """Recursive config merge (opensphere/utils.py:32-43)."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def fill_config(config: dict, base_dir: str | Path | None = None) -> dict:
    """`base`-block inheritance, applied recursively: any sub-dict at any
    depth may name a `base` YAML file whose contents it overrides
    (opensphere/utils.py:44-52). Relative `base` paths resolve against
    `base_dir` (normally the including file's directory)."""
    if not isinstance(config, dict):
        return config
    if "base" in config:
        path = Path(config["base"])
        if base_dir is not None and not path.is_absolute():
            path = Path(base_dir) / path
        with open(path) as f:
            base = yaml.safe_load(f)
        config = deep_merge(base, {k: v for k, v in config.items() if k != "base"})
    return {k: fill_config(v, base_dir) if isinstance(v, dict) else v
            for k, v in config.items()}


def load_config(path: str | Path) -> dict:
    """A recipe file with its `base:` blocks filled, relative to its folder."""
    with open(path) as f:
        return fill_config(yaml.safe_load(f), base_dir=Path(path).parent)


def build_backbone(cfg: dict):
    """cfg like {"type": "sfnet20", "out_channel": 512} (the reference's
    model.backbone.net block, built at exp-1:970-989) -> an nn.Module on the
    CPU with torch's default init (the trainer seeds it)."""
    cfg = dict(cfg)
    kind = cfg.pop("type")
    cfg.pop("in_channel", None)  # NHWC input is implicit
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()
          if k in ("out_channel", "layers", "channels", "in_size")}
    return BACKBONES[kind](**kw)


def build_head(cfg: dict):
    """cfg like {"type": "sphereface", "s": 30, "m": 1.5} -> (fn, kwargs)."""
    cfg = dict(cfg)
    kind = cfg.pop("type").lower()
    cfg.pop("feat_dim", None)
    cfg.pop("num_class", None)
    # reference configs use mixed-case kwargs (lambda_MHE); the head
    # functions use lowercase argument names
    cfg = {k.lower(): v for k, v in cfg.items()}
    return margin_heads.HEADS[kind], cfg
