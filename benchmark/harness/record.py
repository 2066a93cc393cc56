"""What a run hands the per-layer metric readers."""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
import json
from typing import Any, Optional

from benchmark.harness import arith
from benchmark.harness.models import ref_sd_config, zoo_sizes
from benchmark.harness.spec import ROOT
from benchmark.harness.trace import Spans, TraceResult


@dataclasses.dataclass
class RunRecord:
    kind: str  # the traffic kind: "train" or "gen"
    config: dict
    traffic: dict
    window_s: float
    # train: one dict an untraced step ("n_steps", "phases", "wall_s"); gen: one a batch ("images", "n_steps")
    work: list[dict]
    spans: Spans
    window_ns: tuple[int, int]
    peak_bytes: int
    trace: Optional[TraceResult] = None
    traced: Optional[list[dict]] = None  # the work the trace covers; None: all of `work`

    @property
    def traced_work(self) -> list[dict]:
        return self.work if self.traced is None else self.traced

    @functools.cached_property
    def sd_config(self) -> Any:
        return ref_sd_config(self.config)

    @functools.cached_property
    def unit_flops(self) -> dict[str, float]:
        return unit_flops(self.config)

    def span_s(self, name: str) -> float:
        return self.spans.total_s(name, *self.window_ns)


def unit_flops(config: dict) -> dict[str, float]:
    """`arith.unit_flops` of the configuration, kept under build/benchmark/
    of the checkout (keyed on the configuration and on arith.py), so a
    checkout counts them once."""
    args = (ref_sd_config(config), zoo_sizes(config), config["lora"]["target"])
    key = hashlib.sha256((repr(args) + inspect.getsource(arith)).encode()).hexdigest()[:16]
    path = ROOT / "build" / "benchmark" / f"unit_flops-{key}.json"
    if path.exists():
        return json.loads(path.read_text())
    flops = arith.unit_flops(*args)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(flops))
    return flops


def prepare(config: dict) -> None:
    """Count, ahead of the readers, what they count from the configuration
    (its unit FLOPs, the UNet's attention and GEGLU operations), all on the
    host; a traced run does it in a thread while the reference runs."""
    unit_flops(config)
    arith.unet_ops(ref_sd_config(config).unet)
