"""Run one cell of BENCHMARK.json once:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device`, with
`--trace 1` also `breakdown`, and last `checks`, each compared number
beside its limit (also the last lines of standard error).

It needs as many CUDA devices as the cell asks for and exits with code 2
without a result otherwise, and with code 3 without a result if jax,
jaxlib, flax or the JAX package fairdiff (whole top-level names) is loaded
when the window has closed. The program's nvcc libraries stay in
build/fairdiff_torch/ of the checkout, where fairdiff_torch/kernels/build.py
puts them; Triton's and torch's extension caches are fixed under build/ too.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "fairdiff")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: fairdiff_torch is not fairdiff."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


class Context:
    """What a driver gets: the cell, the run's arguments, the device."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float):
        import torch

        from benchmark.harness.trace import Spans

        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = torch.device(device)
        self.dtype = getattr(torch, cell["config"]["dtype"])
        self.t_start = t_start
        self.spans = Spans()
        self._building, self._build_error = None, None
        if self.device.type == "cuda":
            from fairdiff_torch.kernels import build

            def compile_all():
                try:
                    build.build(build.KERNELS + build.HOST_LIBRARIES)
                except BaseException as e:  # re-raised at the first load
                    self._build_error = e

            # The program builds each library at its first launch, one after
            # another. A checkout's first run builds them all at once here,
            # beside the set-up, and the program's first load waits for that
            # build (a second compiler on the same library would write the
            # same file).
            self._building = threading.Thread(target=compile_all, name="build")
            self._building.start()
            load = build.load

            def load_when_built(name):
                self._wait_for_build()
                return load(name)

            build.load = load_when_built

    def _wait_for_build(self) -> None:
        if self._building is not None:
            self._building.join()
        if self._build_error is not None:
            raise self._build_error

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def peak_bytes(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated(self.device)) if self.device.type == "cuda" else 0

    def empty_cache(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def per_layer(cell: dict, record) -> dict:
    """Each per-layer metric of the cell its reader finds something for."""
    from benchmark.harness.spec import metric_reader

    out = {}
    for m in cell["per_layer"]:
        value = metric_reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Set up, measure and check one cell; -> the result object (without
    the device's name)."""
    from benchmark.harness.spec import driver

    ctx = Context(cell, seed, seconds, trace, device, t_start)
    out = driver(cell["traffic"]["kind"]).run(ctx)
    record = out["record"]
    print(f"[bench] window and check done at {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    if trace:
        metrics = per_layer(cell, record)
        print(f"[bench] per-layer metrics read at {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    else:
        units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        metrics = {k: {"value": float(v), "unit": units[k]} for k, v in out["end_to_end"].items() if k in units}
    result = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": {"memory_peak_bytes": record.peak_bytes}}
    if trace:
        tr = record.trace
        print(f"[trace] {tr.n_events} of {tr.n_all} device events in the window, busy {tr.busy_s:.3f} of "
              f"{tr.window_s:.3f} s; events from {tr.events_from_s:+.3f} to {tr.events_to_s:+.3f} s of its start",
              file=sys.stderr)
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["checks"] = out["checks"]
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    from benchmark.harness.spec import cell as find_cell, load_bench

    cell = find_cell(args.workload, load_bench(ROOT), ROOT)
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"[bench] loaded in this process: {found}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                        **result["device"]}
    result["checks"] = result.pop("checks")
    for name, (value, limit) in result["checks"].items():
        print(f"[check] {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
