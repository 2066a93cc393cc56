"""Config system: dataclass defaults plus YAML overrides with type coercion
(a copy of fairdiff/utils/config.py without its JAX platform switch).

A frozen dataclass is the single source of truth; YAML and CLI overrides are
coerced to each field's declared type, and unknown keys are an error.
PyYAML is imported only to read a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import typing
from pathlib import Path
from typing import Any, Type, TypeVar

T = TypeVar("T")


def _coerce(value: Any, annot: Any) -> Any:
    origin = typing.get_origin(annot)
    if origin is typing.Union:  # Optional[...]
        args = [a for a in typing.get_args(annot) if a is not type(None)]
        if value is None:
            return None
        return _coerce(value, args[0])
    if origin in (list, tuple):
        (item_t,) = typing.get_args(annot)[:1] or (str,)
        if isinstance(value, str):
            # a CLI override arrives as one string: "0.2,0.3" -> items; a
            # scalar string is never split into its characters
            value = [v for v in (p.strip() for p in value.split(",")) if v]
        seq = [_coerce(v, item_t) for v in value]
        return tuple(seq) if origin is tuple else seq
    if annot is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if annot in (int, float, str):
        return annot(value)
    if dataclasses.is_dataclass(annot) and isinstance(value, dict):
        return from_dict(annot, value)
    return value


def from_dict(cls: Type[T], data: dict[str, Any]) -> T:
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {k: _coerce(v, _resolve(cls, fields[k])) for k, v in data.items()}
    return cls(**kwargs)


def _resolve(cls: Type, field: dataclasses.Field) -> Any:
    return typing.get_type_hints(cls)[field.name]


def merge(config: T, overrides: dict[str, Any]) -> T:
    """A copy of `config` with `overrides` applied (type-coerced)."""
    fields = {f.name: f for f in dataclasses.fields(config)}
    unknown = set(overrides) - set(fields)
    if unknown:
        raise KeyError(f"unknown config keys for {type(config).__name__}: {sorted(unknown)}")
    updates = {}
    for key, value in overrides.items():
        current = getattr(config, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            updates[key] = merge(current, value)
        else:
            updates[key] = _coerce(value, _resolve(type(config), fields[key]))
    return dataclasses.replace(config, **updates)


def load_yaml(config: T, path: str | Path) -> T:
    """Apply a YAML override file on top of dataclass defaults
    (reference exp-1:632-638 semantics, with strict unknown-key checking)."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return merge(config, data)


def to_dict(config: Any) -> dict[str, Any]:
    return dataclasses.asdict(config)


def cli_parse(cls: Type[T], argv: list[str] | None = None) -> T:
    """`--config file.yaml` plus `--key value` overrides for every scalar
    field of `cls`. A dataclass with a `config` field of its own takes
    `--config` as that field."""
    parser = argparse.ArgumentParser()
    hints = typing.get_type_hints(cls)
    field_names: set[str] = set()
    for f in dataclasses.fields(cls):
        if dataclasses.is_dataclass(hints[f.name]):
            continue
        parser.add_argument(f"--{f.name}", type=str, default=None)
        field_names.add(f.name)
    if "config" not in field_names:
        parser.add_argument("--config", type=str, default=None)
    ns = parser.parse_args(argv)
    cfg = cls()
    if "config" not in field_names and ns.config:
        cfg = load_yaml(cfg, ns.config)
    overrides = {k: v for k, v in vars(ns).items() if k in field_names and v is not None}
    if overrides:
        cfg = merge(cfg, overrides)
    return cfg
