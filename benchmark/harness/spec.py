"""BENCHMARK.json and the files it names, found by name: a configuration
is `configs/<config>.json` (its `file`), a traffic mix `traffic/<mix>.json`,
a cell's correctness limits `limits/<workload>.json`, a per-layer metric's
reader `metrics/<metric>.py` (a function `read(run)`), and a traffic mix's
driver `drivers/<kind>.py` (a function `run(ctx)`)."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable

HERE = Path(__file__).resolve().parent.parent  # benchmark/
ROOT = HERE.parent


def load_bench(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def cell(name: str, bench: dict, root: Path = ROOT) -> dict:
    """-> {"workload", "config", "traffic", "limits", "end_to_end",
    "per_layer"} of the cell `name`: its entry, the parsed files, and the
    metric entries that apply to it."""
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(workloads)})")
    w = workloads[name]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    applies = lambda m: name in m.get("workloads", [name])
    return {
        "workload": w,
        "config": read_json(root / config["file"]),
        "traffic": read_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json"),
        "limits": read_json(root / "benchmark" / "limits" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def metric_reader(name: str) -> Callable:
    """`read` of `metrics/<name>.py` (metric names hold dots, so the file
    is loaded by path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")
