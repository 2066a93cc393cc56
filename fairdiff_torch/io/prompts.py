"""Prompt JSON loading (a copy of fairdiff/io/prompts.py).

data/1-prompts/occupation.json keys: prompt_templates_train,
occupations_train_set, prompt_templates_test, occupations_val_set,
test_prompts; files that carry train_prompts / val_prompts directly (the
exp-5 domains) are read as they are, and `load_multi_domain_prompts` mixes
several with a repeat factor each.
"""

from __future__ import annotations

import json
from pathlib import Path


def _expand(templates: list[str], occupations: list[str]) -> list[str]:
    return [
        t.format(occupation=o) if "{occupation}" in t else t.replace("{}", o)
        for t in templates
        for o in occupations
    ]


def load_occupation_prompts(path: str | Path) -> dict:
    with open(path) as f:
        data = json.load(f)
    out = dict(data)
    if "prompt_templates_train" in data:
        out.setdefault(
            "train_prompts",
            _expand(data["prompt_templates_train"], data.get("occupations_train_set", [])),
        )
    if "prompt_templates_test" in data:
        out.setdefault(
            "val_prompts",
            _expand(data["prompt_templates_test"], data.get("occupations_val_set", [])),
        )
    return out


def load_multi_domain_prompts(paths: list[str | Path], repeats: list[int]) -> dict:
    """exp-5's mixing: the domains' train prompts concatenated, each domain
    repeated its factor of times (x1/x6/x20/x4 in the reference); val and
    test prompts concatenated once."""
    train, val, test = [], [], []
    for path, rep in zip(paths, repeats):
        dd = load_occupation_prompts(path)
        train += list(dd.get("train_prompts", [])) * rep
        val += list(dd.get("val_prompts", []))
        test += list(dd.get("test_prompts", []))
    return {"train_prompts": train, "val_prompts": val, "test_prompts": test}
