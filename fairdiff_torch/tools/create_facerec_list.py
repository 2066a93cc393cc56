"""Create a ClassDataset annotation list from a class-per-folder image tree
(counterpart of fairdiff/tools/create_facerec_list.py, the same file line
for line).

Parity with opensphere/scripts/create_list.py (the reference walks the
dataset dir and writes "<path> <folder-name>" lines), tightened for
reproducible training: deterministic ordering, integer labels assigned by
sorted class-folder name, and paths relative to the dataset root so the
list stays valid when the tree moves.

Usage:
  python -m fairdiff_torch.tools.create_facerec_list \
      --dataset_dir data/facerec/train --list_path train_ann.txt
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from fairdiff_torch.utils import config as cfglib

_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


@dataclasses.dataclass(frozen=True)
class CreateListConfig:
    dataset_dir: str = ""
    list_path: str = ""  # default: <dataset_dir>_ann.txt
    relative: bool = True  # write paths relative to dataset_dir


def create_list(cfg: CreateListConfig) -> Path:
    root = Path(cfg.dataset_dir)
    if not root.is_dir():
        raise SystemExit(f"--dataset_dir {root} is not a directory")
    out = Path(cfg.list_path or f"{root}_ann.txt")

    class_dirs = sorted(p for p in root.iterdir() if p.is_dir())
    n = 0
    with open(out, "w") as f:
        for label, cdir in enumerate(class_dirs):
            for img in sorted(cdir.rglob("*")):
                if img.suffix.lower() not in _EXTS:
                    continue
                path = img.relative_to(root) if cfg.relative else img
                f.write(f"{path} {label}\n")
                n += 1
    print(f"[create_list] {n} images, {len(class_dirs)} classes -> {out}")
    return out


if __name__ == "__main__":
    create_list(cfglib.cli_parse(CreateListConfig))
