"""BENCHMARK.json against its required shape (keys, names, units, bounds),
and every file it names found by name: configurations, traffic mixes,
limits, drivers, readers."""

from __future__ import annotations

import dataclasses
import importlib
import re

import pytest

from benchmark.harness import spec

BENCH = spec.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"] == ["python3", "-m", "benchmark.run"]


def test_names_units_and_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(workload):
    c = spec.cell(workload, BENCH)
    assert c["traffic"]["kind"] in ("train", "gen")
    assert hasattr(spec.driver(c["traffic"]["kind"]), "run")
    assert set(c["limits"]) and all(v > 0 for v in c["limits"].values())
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in e2e


def test_every_config_is_used_and_its_file_is_its_own():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    for c in BENCH["configs"]:
        data = spec.read_json(spec.ROOT / c["file"])
        assert data["name"] == c["name"] and data["source"] == c["source"] and data["reduced"] == c["reduced"]


def test_configs_are_the_ports_sd15_and_exp1_preset():
    from fairdiff_torch.sampling.pipeline import SDConfig
    from fairdiff_torch.training.presets import exp1

    sd = SDConfig.sd15()
    for c in BENCH["configs"]:
        data = spec.read_json(spec.ROOT / c["file"])
        for key, ours in (("text_encoder", sd.text), ("unet", sd.unet), ("vae", sd.vae)):
            theirs = {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(ours).items()}
            assert data[key] == theirs, key
        assert data["dtype"] == sd.dtype
        preset = dataclasses.asdict(exp1())
        for k, v in data["debias"].items():
            if k in ("train_text_encoder", "train_unet"):
                continue
            assert (list(preset[k]) if isinstance(preset[k], tuple) else preset[k]) == v, k
        target = data["lora"]["target"]
        assert data["debias"]["train_text_encoder"] == (target == "text_encoder")
        assert data["debias"]["train_unet"] == (target == "unet")


def test_drivers_and_readers_import_without_the_program():
    for kind in ("train", "gen"):
        importlib.import_module(f"benchmark.drivers.{kind}")
