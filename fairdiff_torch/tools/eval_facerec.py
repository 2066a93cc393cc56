"""Face-recognition evaluation CLI (counterpart of
fairdiff/tools/eval_facerec.py; opensphere's test entry, test.py:30-176):
flip-sum L2-normalised features over each val dataset, then
PairDataset (ACC/EER/AUC/TPR@FPR) or IJBDataset (template 1:1 and 1:N)
evaluation on the host over the feature table.

Config schema (mirrors the reference's data/model blocks):

  data:
    val:
    - dataset: {type: PairDataset, data_dir: ..., ann_path: ..., name: LFW}
    - dataset: {type: IJBDataset, data_dir: ..., meta_dir: ..., ...}
  model:
    backbone: {type: sfnet20_deprecated, out_channel: 512, in_size: 112}

`--weights` reads a backbone `.npz` in the JAX package's `|`-joined tree
layout (what `train_facerec` writes in either package).

Usage:
  python -m fairdiff_torch.tools.eval_facerec --config cfg.yml \
      --weights outputs/facerec/backbone_final.npz [--device cpu]
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fairdiff_torch.device import resolve_device
from fairdiff_torch.facerec.builder import build_backbone, load_config
from fairdiff_torch.facerec.datasets import IJBDataset, PairDataset, image_pipeline
from fairdiff_torch.facerec.trainer import seed_backbone
from fairdiff_torch.guidance.face_feats import face_embeddings
from fairdiff_torch.io.adapters_io import load_adapters
from fairdiff_torch.io.from_jax import load_jax_params
from fairdiff_torch.utils import config as cfglib


@dataclasses.dataclass(frozen=True)
class EvalFaceRecCLIConfig:
    device: str = ""  # "" = cuda; "cpu" only when asked for
    config: str = ""
    weights: str = ""  # backbone params .npz ('' => seeded random init, smoke only)
    batch_size: int = 64
    seed: int = 0


def _extract_paths(paths, extract, batch_size):
    feats = {}
    for i in range(0, len(paths), batch_size):
        chunk = paths[i: i + batch_size]
        f = extract(np.stack([image_pipeline({"path": p}, True) for p in chunk]))
        for p, v in zip(chunk, f):
            feats[p] = v
    return feats


def main(cli: EvalFaceRecCLIConfig) -> dict:
    device = resolve_device(cli.device)
    cfg = load_config(cli.config)
    backbone = build_backbone(dict(cfg["model"]["backbone"]))
    if cli.weights:
        load_jax_params(backbone, load_adapters(cli.weights))
    else:
        print("[eval-facerec] WARNING: no --weights; random backbone")
        seed_backbone(backbone, torch.Generator().manual_seed(cli.seed))
    backbone = backbone.to(device).eval().requires_grad_(False)

    @torch.no_grad()
    def extract(imgs: np.ndarray) -> np.ndarray:
        return face_embeddings(backbone, torch.as_tensor(imgs, device=device)).cpu().numpy()

    val_entries = cfg["data"]["val"]
    if isinstance(val_entries, dict):
        val_entries = [val_entries]
    results: dict[str, list] = {}
    for entry in val_entries:
        ds_cfg = dict(entry["dataset"])
        kind = ds_cfg.pop("type")
        name = ds_cfg.pop("name", kind)
        if kind == "PairDataset":
            ds = PairDataset(**ds_cfg)
            paths = sorted({p for pair in ds.pairs for p in pair[:2]})
            metrics = ds.evaluate(_extract_paths(paths, extract, cli.batch_size))
        elif kind == "IJBDataset":
            ds = IJBDataset(**ds_cfg)
            feats = [extract(np.stack([ds[j][0] for j in range(i, min(i + cli.batch_size, len(ds)))]))
                     for i in range(0, len(ds), cli.batch_size)]
            metrics = ds.evaluate(np.concatenate(feats))
        else:
            raise ValueError(f"unknown val dataset type {kind}")
        results[name] = metrics
        row = "  ".join(f"{k}={v:.4f}" for k, v in metrics)
        print(f"[eval-facerec] {name}: {row}")
    return results


if __name__ == "__main__":
    main(cfglib.cli_parse(EvalFaceRecCLIConfig))
