"""Face-recognition training CLI (counterpart of
fairdiff/tools/train_facerec.py; opensphere's `python train.py --config
config/train/...yml`). YAML with `base`-block inheritance, registry
backbones (sfnet*/iresnet*), all 11 margin heads, ClassDataset training,
optional PairDataset verification.

Schema (keys mirror the reference's data/model blocks):

  data:
    train:
      dataset: {type: ClassDataset, data_dir: ..., ann_path: ...,
                noise_ratio: 0.0}
      batch_size: 512
    val:                                 # optional
      dataset: {type: PairDataset, data_dir: ..., ann_path: ...}
  model:
    backbone: {type: sfnet20, out_channel: 512}   # or a `base:` yml
    head: {type: sphereface, s: 30.0, m: 1.5}
  trainer:                               # FaceRecConfig fields
    lr: 0.1
    max_iters: 80000
    lr_decay_steps: [40000, 60000, 70000]
    lr_decay_gamma: 0.1                  # opensphere's key: lr_decay_rate

The shipped recipes' `base.yml` sets `lr_decay_gamma` (opensphere's name
for the MultiStepLR factor); `build_all` maps it onto `lr_decay_rate`.
The weights go to `<output_dir>/backbone_<step>.npz` and
`backbone_final.npz` in the JAX package's `|`-joined tree layout, the
records to `<output_dir>/metrics.jsonl`.

`--data_mesh N` trains data-parallel over N processes, one a device
(each takes its rows of every batch; `FaceRecTrainer` sums the gradients):
start them with torchrun, or join them to a process group before `main`
(`parallel.launch`). Only rank 0 writes files.

Usage:
  python -m fairdiff_torch.tools.train_facerec --config cfg.yml \
      --output_dir outputs/facerec [--max_iters N] [--device cpu]
  torchrun --nproc_per_node 2 -m fairdiff_torch.tools.train_facerec --config cfg.yml --data_mesh 2
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from fairdiff_torch.facerec.builder import build_backbone, build_head, load_config
from fairdiff_torch.facerec.datasets import ClassDataset, PairDataset, image_pipeline
from fairdiff_torch.facerec.trainer import FaceRecConfig, FaceRecTrainer
from fairdiff_torch.io.adapters_io import save_adapters
from fairdiff_torch.parallel.mesh import MeshConfig, barrier, create_mesh, init_distributed, is_main
from fairdiff_torch.training.logging import MetricsLogger
from fairdiff_torch.utils import config as cfglib


@dataclasses.dataclass(frozen=True)
class FaceRecCLIConfig:
    device: str = ""  # "" = cuda; "cpu" only when asked for
    config: str = ""
    output_dir: str = "outputs/facerec"
    max_iters: int = 0  # 0 => config value
    data_mesh: int = 0  # 0 => no mesh (single device); N > 1: N processes, data-parallel
    log_every: int = 100
    save_every: int = 10000
    seed: int = 0


def trainer_config(cfg: dict, num_classes: int, seed: int = 0, max_iters: int = 0) -> FaceRecConfig:
    """The recipe's `trainer` block -> FaceRecConfig, opensphere's
    `lr_decay_gamma` taken as `lr_decay_rate`."""
    tcfg = dict(cfg.get("trainer", {}))
    if "lr_decay_gamma" in tcfg:
        tcfg["lr_decay_rate"] = tcfg.pop("lr_decay_gamma")
    if max_iters:
        tcfg["max_iters"] = max_iters
    if "lr_decay_steps" in tcfg:
        tcfg["lr_decay_steps"] = tuple(tcfg["lr_decay_steps"])
    _, head_kwargs = build_head(cfg["model"]["head"])
    return FaceRecConfig(
        head=cfg["model"]["head"]["type"].lower(),
        head_kwargs=tuple(head_kwargs.items()),
        feat_dim=int(cfg["model"]["backbone"].get("out_channel", 512)),
        num_classes=num_classes,
        seed=seed,
        **tcfg,
    )


def build_all(cli: FaceRecCLIConfig):
    cfg = load_config(cli.config)

    train_ds_cfg = dict(cfg["data"]["train"]["dataset"])
    if train_ds_cfg.pop("type") != "ClassDataset":
        raise ValueError("data.train.dataset.type must be ClassDataset")
    train_ds = ClassDataset(**train_ds_cfg)
    batch_size = int(cfg["data"]["train"].get("batch_size", 512))

    val_ds = None
    if "val" in cfg.get("data", {}):
        val_cfg = dict(cfg["data"]["val"]["dataset"])
        if val_cfg.pop("type") == "PairDataset":
            val_ds = PairDataset(**val_cfg)

    backbone_cfg = dict(cfg["model"]["backbone"])
    tcfg = trainer_config(cfg, train_ds.num_classes, cli.seed, cli.max_iters)
    mesh = None
    if cli.data_mesh > 1:
        init_distributed(cli.device)
        mesh = create_mesh(MeshConfig(data=cli.data_mesh, model=1), device=cli.device or "cuda",
                           backend=dist.get_backend())
    trainer = FaceRecTrainer(build_backbone(backbone_cfg), tcfg, device=cli.device, mesh=mesh)
    return trainer, train_ds, val_ds, batch_size, int(backbone_cfg.get("in_size", 112))


def main(cli: FaceRecCLIConfig, init_params: Optional[Mapping[str, Any]] = None) -> dict:
    """Train and save; -> the final state. `init_params` (the JAX trainer's
    `state["params"]`) replaces the seeded init."""
    trainer, train_ds, val_ds, batch_size, in_size = build_all(cli)
    out = Path(cli.output_dir)
    main_rank = is_main()
    logger = MetricsLogger(out, run_name="facerec") if main_rank else (lambda step, logs: None)
    if init_params is None:
        state = trainer.init_state(torch.Generator().manual_seed(cli.seed))
    else:
        state = trainer.init_state(params=init_params)

    def val_fn(state):
        paths = sorted({p for pair in val_ds.pairs for p in pair[:2]})
        feats = {}
        for i in range(0, len(paths), 64):
            chunk = paths[i: i + 64]
            imgs = np.stack([image_pipeline({"path": p}, True) for p in chunk])
            for p, v in zip(chunk, trainer.extract_features(state, imgs).cpu().numpy()):
                feats[p] = v
        return dict(val_ds.evaluate(feats))

    def checkpoint_cb(st):
        if main_rank:
            save_adapters(out / f"backbone_{st['step']}.npz", trainer.backbone_tree(st))
        barrier()  # no rank reads a checkpoint before it is whole

    state = trainer.fit(
        state,
        train_ds.batches(batch_size, seed=cli.seed, image_size=in_size),
        log_every=cli.log_every,
        logger=logger,
        val_fn=val_fn if val_ds is not None and main_rank else None,
        checkpoint_cb=checkpoint_cb,
        save_interval=cli.save_every,
    )
    if main_rank:
        save_adapters(out / "backbone_final.npz", trainer.backbone_tree(state))
        print(json.dumps({"final_step": state["step"]}))
        logger.close()
    barrier()
    return state


if __name__ == "__main__":
    main(cfglib.cli_parse(FaceRecCLIConfig))
