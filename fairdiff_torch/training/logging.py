"""Metrics logging (a copy of fairdiff/training/logging.py): JSONL always,
wandb as an optional mirror.

`<output_dir>/metrics.jsonl` holds one record a call: `step`, `time`, then
the logs. With `use_wandb` the records also go to wandb when it can start;
when it cannot (not installed, no network) the logger says so and carries on
with JSONL.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


class MetricsLogger:
    def __init__(self, output_dir: str | Path, use_wandb: bool = False,
                 run_name: str = "", config: Optional[dict] = None):
        self.path = Path(output_dir)
        self.path.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path / "metrics.jsonl", "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project="fairdiff", name=run_name or None, config=config)
            except Exception as e:  # no network, or wandb absent
                print(f"[logging] wandb unavailable ({e}); JSONL only")

    def __call__(self, step: int, logs: dict) -> None:
        rec = {"step": step, "time": time.time(), **logs}
        self._f.write(json.dumps(rec, default=float) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(logs, step=step)

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
