"""Validate the reference data contract / synthesize an offline dev bundle
(counterpart of fairdiff/tools/setup_data.py: the same checks and the same
bundle, file for file; the converted-assets check names the port's files,
`clip_vision.pt` and `dinov2.pt` where the JAX package has orbax trees).

Parity with the reference's dataset setup story: `opensphere/scripts/*`
(download + list-creation shell scripts) and the hardcoded `data/` zip
layout every trainer expects (SURVEY.md §2.3; exp-1-debias-gender/
1-main-debias.py:87,:534,:551-552,:906-924; exp-3:156; exp-5:551-565;
eval-generated-images.py:515-531). Downloads are impossible in a
zero-egress environment, so this CLI does the two things that remain
useful:

  check      verify an existing reference `data/` unzip (and optionally a
             converted-assets dir + converted SD dir) against what each
             experiment actually reads, and report per-experiment readiness:
               python -m fairdiff_torch.tools.setup_data --data_dir data \\
                   --assets_dir converted-guidance --model_dir converted-sd15
  synthesize write a complete synthetic bundle (prompt JSONs in the exact
             reference schema + face-feats DBs in both pickle layouts) so
             every fairdiff CLI can run end-to-end with no real assets:
               python -m fairdiff_torch.tools.setup_data --synthetic_out data-dev

Model weights are out of scope here: real ones come from
tools/convert_sd + tools/convert_guidance, synthetic ones from random
init (tools/train_detector, tools/train_facerec).
"""

from __future__ import annotations

import dataclasses
import json
import pickle
from pathlib import Path

import numpy as np

from fairdiff_torch.utils import config as cfglib


@dataclasses.dataclass(frozen=True)
class SetupDataConfig:
    data_dir: str = ""  # reference data.zip unzip root
    assets_dir: str = ""  # tools/convert_guidance output (model_zoo layout)
    model_dir: str = ""  # tools/convert_sd output (the port's converted store)
    synthetic_out: str = ""  # write a synthetic dev bundle here instead
    seed: int = 0


# (experiment, item label, relative path or glob, experiments that need it)
# Globs let the check tolerate the reference's dated/model-named subdirs.
_DATA_ITEMS = [
    ("prompts: occupation.json", "1-prompts/occupation.json",
     ("exp1", "exp2", "exp3", "exp4", "exp6")),
    ("prompts: occupation_w_style_and_context.json",
     "1-prompts/occupation_w_style_and_context.json", ("exp5",)),
    ("prompts: personal_descriptor.json",
     "1-prompts/personal_descriptor.json", ("exp5",)),
    ("prompts: sports.json", "1-prompts/sports.json", ("exp5",)),
    ("training attribute classifier (.pt/.pth)",
     "2-trained-classifiers/**/*.pt*",
     ("exp1", "exp2", "exp3", "exp4", "exp5", "exp6")),
    ("face-feature DB (face_feats.pkl)", "3-face-features/**/face_feats.pkl",
     ("exp1", "exp2", "exp3", "exp4", "exp5", "exp6")),
    ("opensphere face-rec checkpoint", "4-*/**/*.pth",
     ("exp1", "exp2", "exp3", "exp4", "exp5", "exp6")),
    ("held-out test classifiers", "5-trained-test-classifiers/**/*.pt*",
     ("eval",)),
]

# converted-assets layout consumed by fairdiff_torch/training/model_zoo.py
_ASSET_ITEMS = [
    ("face detector (det_10g.onnx or detector.npz)",
     ("det_10g.onnx", "detector.npz")),
    ("attribute classifier (classifier.npz)", ("classifier.npz",)),
    ("CLIP-ViT-H state dict (clip_vision.pt)", ("clip_vision.pt",)),
    ("DINOv2 state dict (dinov2.pt)", ("dinov2.pt",)),
    ("SFNet embedder (face_embedder.npz)", ("face_embedder.npz",)),
    ("face-feature DB (face_feats.pkl)", ("face_feats.pkl",)),
]


def _check_prompts_json(path: Path) -> str | None:
    """Deep-check a prompt JSON: loadable and yielding non-empty splits."""
    from fairdiff_torch.io.prompts import load_occupation_prompts

    try:
        dd = load_occupation_prompts(path)
    except Exception as e:  # malformed JSON is a report line, not a crash
        return f"unreadable ({e})"
    if not dd.get("train_prompts"):
        return "no train prompts derivable"
    return None


def _check_face_feats(path: Path) -> str | None:
    try:
        with open(path, "rb") as f:
            data = pickle.load(f)
    except Exception as e:
        return f"unreadable ({e})"
    if not isinstance(data, (tuple, list)) or len(data) < 2:
        return "not a (feats, genders, ...) tuple"
    n = np.asarray(data[0]).shape[0]
    layout = "exp-3+ (5-tuple)" if len(data) >= 5 else "exp-1 (3-tuple)"
    return f"ok: {n} faces, {layout}"  # informational, not an error


def check(cfg: SetupDataConfig) -> dict:
    """Print a readiness report; return {experiment: [missing labels]}."""
    missing: dict[str, list[str]] = {}
    if cfg.data_dir:
        root = Path(cfg.data_dir)
        for label, pattern, exps in _DATA_ITEMS:
            hits = sorted(root.glob(pattern))
            note = ""
            if hits and pattern.endswith(".json"):
                err = _check_prompts_json(hits[0])
                if err:
                    hits, note = [], f" ({err})"
            elif hits and "face_feats" in pattern:
                note = f" ({_check_face_feats(hits[0])})"
            status = "ok     " if hits else "MISSING"
            print(f"[{status}] {label}{note}  [{', '.join(exps)}]")
            if not hits:
                for e in exps:
                    missing.setdefault(e, []).append(label)
    if cfg.assets_dir:
        adir = Path(cfg.assets_dir)
        for label, names in _ASSET_ITEMS:
            ok = any((adir / n).exists() for n in names)
            print(f"[{'ok     ' if ok else 'MISSING'}] assets: {label}")
            if not ok:
                missing.setdefault("assets", []).append(label)
    if cfg.model_dir:
        mdir = Path(cfg.model_dir)
        ok = mdir.is_dir() and any(mdir.iterdir())
        print(f"[{'ok     ' if ok else 'MISSING'}] converted SD store: {mdir}")
        if not ok:
            missing.setdefault("sd", []).append("converted SD store")
    ready = sorted(
        e for e in ("exp1", "exp2", "exp3", "exp4", "exp5", "exp6", "eval")
        if e not in missing
    )
    if cfg.data_dir:
        print(f"[setup-data] ready experiments: {', '.join(ready) or 'none'}")
    return missing


_TEMPLATES = ["A photo of the face of a {occupation}, a person"]
_OCCUPATIONS = ["teacher", "doctor", "engineer", "chef", "pilot",
                "farmer", "artist", "lawyer"]


def _feats(rng: np.random.Generator, n: int, d: int = 512) -> np.ndarray:
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def synthesize(cfg: SetupDataConfig) -> Path:
    """Write a synthetic bundle in the reference `data/` schema."""
    out = Path(cfg.synthetic_out)
    rng = np.random.default_rng(cfg.seed)

    pdir = out / "1-prompts"
    pdir.mkdir(parents=True, exist_ok=True)
    occ = {
        "prompt_templates_train": _TEMPLATES,
        "occupations_train_set": _OCCUPATIONS[:6],
        "prompt_templates_test": _TEMPLATES,
        "occupations_val_set": _OCCUPATIONS[6:],
        "test_prompts": [
            _TEMPLATES[0].format(occupation=o) for o in _OCCUPATIONS[6:]
        ],
    }
    (pdir / "occupation.json").write_text(json.dumps(occ, indent=1))
    # exp-5 domain files carry ready-made splits (exp-5:551-565)
    for name, noun in [
        ("occupation_w_style_and_context.json", "doctor in an office"),
        ("personal_descriptor.json", "kind person"),
        ("sports.json", "tennis player"),
    ]:
        dd = {
            "train_prompts": [f"A photo of the face of a {noun}"],
            "val_prompts": [f"A portrait of a {noun}"],
            "test_prompts": [f"A picture of a {noun}"],
        }
        (pdir / name).write_text(json.dumps(dd, indent=1))

    n = 64
    genders = rng.integers(0, 2, n).astype(np.int64)
    races = rng.integers(0, 4, n).astype(np.int64)
    f1 = out / "3-face-features/exp1"
    f1.mkdir(parents=True, exist_ok=True)
    with open(f1 / "face_feats.pkl", "wb") as f:
        # exp-1 layout: (feats, genders, logits) — exp-1:87
        pickle.dump((_feats(rng, n), genders,
                     rng.standard_normal((n, 2)).astype(np.float32)), f)
    f3 = out / "3-face-features/exp3"
    f3.mkdir(parents=True, exist_ok=True)
    with open(f3 / "face_feats.pkl", "wb") as f:
        # exp-3+ layout: (feats, genders, g_logits, races, r_logits) — exp-3:156
        pickle.dump((_feats(rng, n), genders,
                     rng.standard_normal((n, 2)).astype(np.float32), races,
                     rng.standard_normal((n, 4)).astype(np.float32)), f)

    (out / "README.txt").write_text(
        "Synthetic fairdiff dev bundle (fairdiff.tools.setup_data).\n"
        "Prompt JSONs follow the reference schema; face_feats.pkl files are\n"
        "random unit vectors in both reference layouts. Model weights are\n"
        "NOT included: convert real ones (tools/convert_sd,\n"
        "tools/convert_guidance) or train synthetic ones\n"
        "(tools/train_detector, tools/train_facerec).\n"
    )
    print(f"[setup-data] synthetic bundle -> {out}")
    return out


def main(cfg: SetupDataConfig) -> dict:
    if cfg.synthetic_out:
        synthesize(cfg)
        return {}
    if not (cfg.data_dir or cfg.assets_dir or cfg.model_dir):
        raise SystemExit(
            "nothing to do: pass --data_dir/--assets_dir/--model_dir to "
            "check, or --synthetic_out to synthesize"
        )
    return check(cfg)


if __name__ == "__main__":
    raise SystemExit(1 if main(cfglib.cli_parse(SetupDataConfig)) else 0)
