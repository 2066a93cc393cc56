"""Checkpoint and resume on the reference's dual cadence (counterpart of
fairdiff/training/checkpoints.py, written for torch).

`<directory>/tmp/<step>.pt` every `tmp_every` steps, keeping the newest
`tmp_keep`; `<directory>/perm/<step>.pt` every `perm_every` steps, kept for
good (a step on both cadences goes to `perm/`). A checkpoint holds the
adapters, the AdamW `state_dict()`, the EMA, `step` and `updates` (the
count of finite updates, which drives the learning-rate warm-up), written by
`torch.save` and read with `weights_only=True`. No RNG state is saved: every
draw derives from (seed, step). Each file is written under a temporary name
and renamed, so a run killed while saving leaves the previous checkpoints
whole. The JAX package's orbax trees are not read here.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Optional

import torch

from fairdiff_torch.training.debias import DebiasState
from fairdiff_torch.utils.tree import tree_leaves, tree_map


def _paths(tree: Any, prefix: tuple = ()) -> list[tuple]:
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


class DualCadenceCheckpointer:
    def __init__(self, directory: str | Path, *, tmp_every: int = 20, perm_every: int = 200,
                 tmp_keep: int = 2):
        self.directory = Path(directory).absolute()
        self.tmp_every = tmp_every
        self.perm_every = perm_every
        self.tmp_keep = tmp_keep

    def all_steps(self, which: str) -> list[int]:
        """The steps saved under `which` ("tmp" or "perm"), ascending."""
        d = self.directory / which
        return sorted(int(p.stem) for p in d.glob("*.pt")) if d.is_dir() else []

    def _save(self, which: str, state: DebiasState) -> None:
        detach = lambda t: t.detach()
        payload = {
            "adapters": tree_map(detach, state.adapters),
            "opt": state.opt.state_dict(),
            "ema": tree_map(detach, state.ema),
            "step": state.step,
            "updates": state.updates,
        }
        d = self.directory / which
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / f"{state.step}.pt.partial"
        torch.save(payload, tmp)
        os.replace(tmp, d / f"{state.step}.pt")

    def maybe_save(self, state: DebiasState) -> None:
        if self.perm_every and state.step % self.perm_every == 0:
            self._save("perm", state)
        elif self.tmp_every and state.step % self.tmp_every == 0:
            self._save("tmp", state)
            for old in self.all_steps("tmp")[: -self.tmp_keep]:
                (self.directory / "tmp" / f"{old}.pt").unlink()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps("tmp") + self.all_steps("perm")
        return max(steps) if steps else None

    def restore(self, template: DebiasState, step: Optional[int] = None) -> DebiasState:
        """The checkpoint of `step` (default the latest) loaded into
        `template`, a fresh `init_state` of the same configuration: its
        adapter and EMA leaves are overwritten in place (the optimizer keeps
        them as its parameters) on their own device, and the optimizer takes
        the saved state."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        which = "perm" if step in self.all_steps("perm") else "tmp"
        path = self.directory / which / f"{step}.pt"
        leaves = tree_leaves(template.adapters)
        device = leaves[0].device if leaves else torch.device("cpu")
        payload = torch.load(path, map_location=device, weights_only=True)
        with torch.no_grad():
            for name in ("adapters", "ema"):
                want, got = getattr(template, name), payload[name]
                if _paths(want) != _paths(got):
                    raise ValueError(f"{path}: its {name} tree differs from the template's")
                for dst, src in zip(tree_leaves(want), tree_leaves(got)):
                    if dst.shape != src.shape:
                        raise ValueError(f"{path}: {name} leaf {tuple(src.shape)} for {tuple(dst.shape)}")
                    dst.copy_(src)
        template.opt.load_state_dict(payload["opt"])
        return DebiasState(template.adapters, template.opt, template.ema, int(payload["step"]),
                           int(payload["updates"]))

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for (the JAX package's
        orbax managers save in the background)."""

    def close(self) -> None:
        """Nothing is held open between saves."""
