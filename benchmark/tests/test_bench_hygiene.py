"""Import hygiene: no module a run loads has the top-level name jax, jaxlib,
flax or fairdiff (compared whole: fairdiff_torch is not fairdiff), and the
reference's modules load nothing of fairdiff_torch."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark import run as bench_run
from benchmark.harness.spec import ROOT


def _loaded_after(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_whole_run_loads_no_jax_and_no_fairdiff():
    code = ("import time, torch; torch.set_num_threads(1)\n"
            "from benchmark import run\nfrom benchmark.tests.tiny import tiny_cell\n"
            "for w in ('gen-unet-lora', 'train-exp1'):\n"
            "    run.run_cell(tiny_cell(w), 7, 0.1, False, 'cpu', time.perf_counter())\n")
    loaded = _loaded_after(code)
    tops = {m.split(".")[0] for m in loaded}
    assert "fairdiff_torch" in tops  # the program ran
    assert not tops & set(bench_run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import pkgutil, importlib, benchmark.reference as r\n"
            "for m in pkgutil.iter_modules(r.__path__):\n"
            "    importlib.import_module('benchmark.reference.' + m.name)\n"
            "import benchmark.harness.arith, benchmark.harness.models, benchmark.harness.traffic\n")
    tops = {m.split(".")[0] for m in _loaded_after(code)}
    assert "benchmark" in tops
    assert not tops & {"fairdiff_torch", *bench_run.FORBIDDEN}


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("fairdiff_torch_lookalike", sys)
    try:
        assert "fairdiff_torch_lookalike" not in bench_run.forbidden_modules()
    finally:
        del sys.modules["fairdiff_torch_lookalike"]
