"""Run one function in several fresh processes joined in one process group.

    results = spawn("package.module:function", world=2, backend="gloo",
                    kwargs={...}, workdir=tmp_dir, timeout=300)

Each rank is `python -m fairdiff_torch.parallel.launch <spec> <rank>`: it
sets one CPU thread (unless told otherwise), joins the group over a
`FileStore` in `workdir` (no TCP port, so concurrent launches cannot
collide), on CUDA drives card `rank % cards`, calls `function(**kwargs)`
and saves what it returns (moved to the CPU) for the parent. The module
that defines the function is imported in each child: keep it light. A
child that fails or outlives `timeout` fails the launch, and every child
still running is killed.

torchrun or `--distributed` (`mesh.init_distributed`) start the CLIs the
same way on real clusters; this launcher serves the tools, tests and
`chip_smoke.py`, which need the ranks' return values.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any

import torch

from fairdiff_torch.device import resolve_device


def spawn(target: str, world: int, *, backend: str, kwargs: dict | None = None,
          workdir: str | Path, timeout: float, device: str | None = None, threads: int = 1) -> list[Any]:
    """`target` ("module:function") run as function(**kwargs) on `world`
    ranks, on the cards unless `device` is "cpu"; -> each rank's return
    value, by rank. Raises, as `resolve_device` does, when CUDA is implied
    and absent."""
    device = resolve_device(device).type
    workdir = Path(workdir).absolute()
    workdir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}-{time.monotonic_ns()}"
    spec = workdir / f"spawn-{tag}.pt"
    store = workdir / f"store-{tag}"
    torch.save({"target": target, "world": world, "backend": backend, "kwargs": kwargs or {},
                "store": str(store), "device": device, "threads": threads, "sys_path": list(sys.path)}, spec)
    logs = [workdir / f"rank{r}-{tag}.log" for r in range(world)]
    root = str(Path(__file__).resolve().parents[2])  # the directory holding fairdiff_torch
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    procs = []
    for rank in range(world):
        with open(logs[rank], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "fairdiff_torch.parallel.launch", str(spec), str(rank)],
                stdout=log, stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if failed:
                raise RuntimeError(_failure(f"rank {failed[0]} exited {procs[failed[0]].returncode}", logs))
            if time.monotonic() > deadline:
                raise TimeoutError(_failure(f"ranks still running after {timeout} s", logs))
            time.sleep(0.1)
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(_failure(f"rank {failed[0]} exited {procs[failed[0]].returncode}", logs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = [torch.load(_result_path(spec, r), weights_only=False) for r in range(world)]
    for path in [spec, store, *logs, *(_result_path(spec, r) for r in range(world))]:
        path.unlink(missing_ok=True)
    return results


def _failure(what: str, logs: list[Path]) -> str:
    tails = []
    for r, path in enumerate(logs):
        text = path.read_text(errors="replace") if path.exists() else ""
        tails.append(f"--- rank {r} ---\n{text[-4000:]}")
    return f"spawn: {what}\n" + "\n".join(tails)


def _result_path(spec: Path, rank: int) -> Path:
    return spec.with_name(f"{spec.stem}-result{rank}.pt")


def _to_cpu(x: Any) -> Any:
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _child(spec_path: str, rank: int) -> None:
    import torch.distributed as dist

    from fairdiff_torch.parallel.mesh import TIMEOUT

    spec = torch.load(spec_path, weights_only=False)
    sys.path[:0] = [p for p in spec["sys_path"] if p not in sys.path]
    torch.set_num_threads(spec["threads"])
    if torch.device(spec["device"]).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(spec["backend"], init_method=f"file://{spec['store']}",
                            world_size=spec["world"], rank=rank, timeout=TIMEOUT)
    try:
        module, _, name = spec["target"].partition(":")
        result = getattr(importlib.import_module(module), name)(**spec["kwargs"])
        torch.save(_to_cpu(result), _result_path(Path(spec_path), rank))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    try:
        _child(sys.argv[1], int(sys.argv[2]))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
