"""Tracing and profiling helpers (counterpart of fairdiff/utils/profiling.py).

Usage:
    with trace_to("outputs/trace", device=sd.device):   # a Chrome trace
        state = trainer.fit(state, prompt_ids, max_steps=1)

    timers = PhaseTimers(device)
    with timers("phase1"):
        ...
    print(timers.last)

`utils/trace_summary.py` sums the device time of such a trace by kernel.
"""

from __future__ import annotations

import contextlib
import gzip
import os
import shutil
import time
from pathlib import Path

import torch

from fairdiff_torch.utils.tree import tree_leaves


@contextlib.contextmanager
def trace_to(log_dir: str | Path, device: torch.device | str = "cuda"):
    """`torch.profiler` over the block, CPU and CUDA activity (the CPU alone
    when `device` is the CPU), written on exit as one Chrome trace
    `<log_dir>/<pid>.<ns>.trace.json.gz`."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    path = log_dir / f"{os.getpid()}.{time.time_ns()}.trace.json"
    prof.export_chrome_trace(str(path))
    with open(path, "rb") as src, gzip.open(path.with_suffix(".json.gz"), "wb") as dst:
        shutil.copyfileobj(src, dst)
    path.unlink()


class PhaseTimers:
    """Wall seconds per named phase of the last step, the device synchronised
    at each exit so a phase's time includes its device work."""

    def __init__(self, device: torch.device):
        self.device = device
        self.last: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.last[name] = time.perf_counter() - t0


def _leaves(tree) -> list:
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    if isinstance(tree, dict):
        return [leaf for leaf in tree_leaves(tree) for leaf in _leaves(leaf)]
    return [] if tree is None else [tree]


def tree_fingerprint(tree) -> dict[str, float]:
    """A cheap sanity fingerprint of a nested dict or list of tensors (the
    reference's `model_sanity_print`): the first element of the first leaf
    (dict keys in sorted order, as JAX flattens them) and the L2 norm of all
    leaves together, in fp32."""
    leaves = [torch.as_tensor(leaf) for leaf in _leaves(tree)]
    if not leaves:
        return {"first": 0.0, "norm": 0.0}
    total = torch.sqrt(sum((leaf.detach().float() ** 2).sum() for leaf in leaves))
    return {"first": float(leaves[0].reshape(-1)[0]), "norm": float(total)}
