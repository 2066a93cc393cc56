"""The ("data", "model") mesh on torch.distributed (counterpart of
fairdiff/parallel/mesh.py).

One process drives one device. The JAX package builds one `Mesh` over every
device of one program and lets XLA insert the collectives; here every
process joins a process group (`init_distributed`, or a launcher such as
torchrun or `parallel.launch`), `create_mesh` lays the world out as a 2-D
`DeviceMesh`, and the callers make the collectives themselves:

- `shard_batch` gives this rank its rows of the global batch (a JAX
  batch-sharded array *is* the global array; here each rank holds its
  `local_slice`);
- `replicated` broadcasts from data-rank 0 (the reference's rank-0
  broadcasts, exp-1:821/:1832);
- `all_sum` and `gather_rows` are the reference's manual gradient
  all-reduce (exp-1:1996-2011) and `customized_all_gather` (exp-1:222-235).

`with_sharding` (an in-jit sharding constraint for XLA's partitioner) has
no counterpart: nothing here partitions a program.

The backend is NCCL for CUDA and gloo for the CPU, from the device, unless
the caller names one (gloo carries CUDA tensors too, which lets two ranks
share one card: NCCL refuses two ranks on one device). Every collective
here is an all-reduce or a broadcast, the two that gloo runs on CUDA
tensors; half-precision tensors are reduced in fp32.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from fairdiff_torch.utils.tree import tree_leaves, tree_unflatten


AXES = ("data", "model")
# a rendezvous or collective that waits longer than this fails
TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh layout.

    data:  batch / image-ensemble parallelism (the reference's only axis,
           2-way DP over A100s).
    model: tensor-parallel axis, Megatron-style column/row sharding of the
           UNet and CLIP attention heads and the TE MLP (parallel/tp.py).
    """

    data: int = -1  # -1 = all remaining devices
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = max(1, self.model)
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} does not tile {n_devices} devices"
            )
        return data, model


def default_backend(device: torch.device | str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device: str = "", coordinator_address: str = "", num_processes: int = 0,
                     process_id: int = -1) -> None:
    """Join the process group, unless this process has joined one: a
    `tcp://` rendezvous at `coordinator_address` (host:port) of
    `num_processes` with this one as `process_id`, or, without an address,
    `env://` as torchrun sets it. The backend follows `device` ("" is
    CUDA): NCCL on a card, gloo on the CPU."""
    if dist.is_initialized():
        return
    backend = default_backend(device or "cuda")
    if coordinator_address:
        kwargs = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes or 1,
                      rank=max(process_id, 0))
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        kwargs = dict(init_method="env://")
    else:
        raise RuntimeError("no process group to join: start the processes with torchrun (env://), or give "
                           "each its coordinator_address, num_processes and process_id")
    if backend == "nccl":
        torch.cuda.set_device(local_device_index())
    dist.init_process_group(backend, timeout=TIMEOUT, **kwargs)
    print(f"[distributed] process {dist.get_rank()}/{dist.get_world_size()} on {backend}", flush=True)


def local_device_index() -> int:
    """The card this process drives: torchrun's LOCAL_RANK, else the rank,
    modulo the cards this host has."""
    index = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return index % max(torch.cuda.device_count(), 1)


def create_mesh(config: MeshConfig | None = None, *, device: torch.device | str = "cuda",
                backend: str | None = None) -> DeviceMesh:
    """A 2-D ("data", "model") mesh over the initialised world, ranks in
    row-major order (the model axis innermost, as the JAX mesh reshapes
    `jax.devices()`). The world must run `backend` (default: NCCL for a
    CUDA `device`, gloo for the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialised process group (init_distributed, torchrun)")
    backend = backend or default_backend(device)
    if dist.get_backend() != backend:
        raise ValueError(f"the world runs {dist.get_backend()}, not {backend}")
    data, model = (config or MeshConfig()).resolve(dist.get_world_size())
    # the mesh's own device type only matters to DTensor, which nothing
    # here uses; "cpu" keeps DeviceMesh from picking a card for gloo ranks
    mesh_device = "cuda" if backend == "nccl" else "cpu"
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(mesh_device, ranks, mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh | None, axis: str) -> int:
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_index(mesh: DeviceMesh | None, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def is_main() -> bool:
    """True on the process that writes files (global rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def local_slice(n: int, axis_size: int, axis_index: int) -> slice:
    """The reference slices gathered tensors back to a per-rank span
    (exp-1:1836-1838)."""
    per = math.ceil(n / axis_size)
    return slice(axis_index * per, min((axis_index + 1) * per, n))


def data_slice(mesh: DeviceMesh | None, n: int) -> slice:
    """This rank's span of `n` global rows."""
    return local_slice(n, axis_size(mesh, "data"), axis_index(mesh, "data"))


def shard_batch(mesh: DeviceMesh | None, tree: Any, axis: int = 0) -> Any:
    """This rank's rows of every leaf, along `axis`, over the data axis."""

    return _map(lambda x: x[(slice(None),) * axis + (data_slice(mesh, x.shape[axis]),)], tree)


def replicated(mesh: DeviceMesh | None, tree: Any) -> Any:
    """Every tensor leaf broadcast in place from data-rank 0 (each model
    rank keeps its own shard); returns the tree."""
    if axis_size(mesh, "data") > 1:
        group = mesh.get_group("data")
        src = dist.get_global_rank(group, 0)
        for x in _tensors(tree):
            dist.broadcast(x, src=src, group=group)
    return tree


def _map(fn, tree: Any) -> Any:
    """`fn` on every leaf of nested dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _tensors(tree: Any) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _map(lambda x: out.append(x) if torch.is_tensor(x) else None, tree)
    return out


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of `x` over `group`, out of place; half types summed in fp32 and
    bool as int32 (what every backend runs)."""
    if x.dtype in (torch.float16, torch.bfloat16):
        y = x.float()
    elif x.dtype == torch.bool:
        y = x.int()
    else:
        y = x.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype) if x.dtype != torch.bool else y > 0


def all_sum(x: torch.Tensor, mesh: DeviceMesh | None, axis: str) -> torch.Tensor:
    """Sum over the mesh axis (out of place; `x` itself when it has size 1)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _reduce(x, mesh.get_group(axis))


def all_sum_tree(tree: Any, mesh: DeviceMesh | None, axis: str) -> Any:
    """Every tensor leaf of a nested dict (one dtype) summed over the mesh
    axis in one collective; the tree itself when the axis has size 1."""
    if axis_size(mesh, axis) == 1:
        return tree
    leaves = tree_leaves(tree)
    flat = _reduce(torch.cat([x.reshape(-1) for x in leaves]), mesh.get_group(axis))
    parts = flat.split([x.numel() for x in leaves])
    return tree_unflatten(tree, [p.view_as(x) for p, x in zip(parts, leaves)])


def gather_rows(x: torch.Tensor, mesh: DeviceMesh | None, n: int) -> torch.Tensor:
    """The global [n, ...] from every data rank's rows [`data_slice`]:
    zeros outside this rank's span, summed over the data axis (exact: each
    row has one non-zero contribution)."""
    if axis_size(mesh, "data") == 1:
        return x
    buf = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    buf[data_slice(mesh, n)] = x
    return _reduce(buf, mesh.get_group("data"))


class _GatherRows(torch.autograd.Function):
    """`gather_rows` whose backward sums the global gradient over the data
    axis and keeps this rank's rows: for a loss every rank computes alike
    on the gathered rows, scaled by 1 / data, that is the loss's gradient."""

    @staticmethod
    def forward(ctx, x, mesh, n):
        ctx.mesh, ctx.n = mesh, n
        return gather_rows(x, mesh, n)

    @staticmethod
    def backward(ctx, g):
        g = _reduce(g.contiguous(), ctx.mesh.get_group("data"))
        return g[data_slice(ctx.mesh, ctx.n)], None, None


def gather_rows_grad(x: torch.Tensor, mesh: DeviceMesh | None, n: int) -> torch.Tensor:
    """`gather_rows` with the backward of `_GatherRows`."""
    if axis_size(mesh, "data") == 1:
        return x
    return _GatherRows.apply(x, mesh, n)
