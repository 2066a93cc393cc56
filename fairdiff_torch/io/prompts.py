"""Prompt JSON loading (a copy of fairdiff/io/prompts.py
`load_occupation_prompts`).

data/1-prompts/occupation.json keys: prompt_templates_train,
occupations_train_set, prompt_templates_test, occupations_val_set,
test_prompts; files that carry train_prompts / val_prompts directly are
read as they are.
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
