"""Phase 4b's pair VJPs on the CPU: which route `DebiasTrainer._pair_grads`
takes (a CUDA graph only on a CUDA device with a whole UNet), that the CPU
route captures nothing and records the eager spans, and the signature a
pair VJP's CUDA graph is captured for (`pair_signature`); the launch
counters a replay adds to (`fairdiff_torch.ops`). The graphs themselves run
on the card: tests/test_torch_pair_graph_gpu.py."""

from __future__ import annotations

import collections
from types import SimpleNamespace

import pytest
import torch

from fairdiff_torch import ops
from fairdiff_torch.parallel.mesh import AXES
from fairdiff_torch.tools import train_debias
from fairdiff_torch.training.debias import DebiasTrainer, EagerPairTrainer, pair_signature
from fairdiff_torch.utils import profiling


class FakeMesh:
    """What `axis_size` reads of a mesh: the size of each named axis."""

    def __init__(self, **sizes: int):
        self.sizes = sizes

    def size(self, dim: int) -> int:
        return self.sizes.get(AXES[dim], 1)


@pytest.mark.parametrize("device,mesh,graphed", [
    ("cuda", None, True),
    ("cuda", FakeMesh(data=2), True),
    ("cuda", FakeMesh(model=2), False),
    ("cuda", FakeMesh(data=2, model=2), False),
    ("cpu", None, False),
    ("cpu", FakeMesh(model=2), False),
])
def test_graph_route_by_device_and_model_axis(device, mesh, graphed):
    trainer = DebiasTrainer.__new__(DebiasTrainer)  # the route reads only the device and the mesh
    trainer.device, trainer.mesh = torch.device(device), mesh
    assert trainer._graph_pairs is graphed


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_eager_pair_trainer_never_graphs(device):
    trainer = EagerPairTrainer.__new__(EagerPairTrainer)
    trainer.device, trainer.mesh = torch.device(device), None
    assert trainer._graph_pairs is False


@pytest.mark.parametrize("name", list(ops.COUNTERS))
def test_add_launches_adds_to_one_op_counter(name):
    """What a replay adds (`PairGraph.launches`) lands in the op module's
    own counter, which `launch_counts` reads back, and in no other."""
    before = ops.launch_counts()
    try:
        ops.add_launches({name: 3})
        after = ops.launch_counts()
        assert after == {k: n + 3 * (k == name) for k, n in before.items()}
        mod, attr = ops.COUNTERS[name]
        assert getattr(getattr(ops, mod), attr) == before[name] + 3
    finally:
        ops.add_launches({name: -3})
    assert ops.launch_counts() == before


def test_cpu_pair_grads_capture_nothing():
    cfg = train_debias.parse_args(["--device", "cpu", "--tiny_smoke", "1"])
    trainer = train_debias.build_trainer(cfg)
    state = trainer.init_state(0)
    n_text = trainer.sd.config.text.max_position_embeddings
    ids = (torch.arange(n_text)[None] % 60, torch.zeros(1, n_text, dtype=torch.long))
    state, logs = trainer.train_step(state, ids)
    assert logs["grads_finite"] and trainer._pair_graphs == {}
    root = profiling.recorded_spans()[-1]
    spans = [s for s in profiling.recorded_spans() if s.root == root.id]
    names = {s.id: s.name for s in spans}
    pairs = [s for s in spans if s.name == "pair_vjp"]
    chunks = trainer.cfg.train_images_per_prompt // trainer.cfg.train_micro_batch
    assert len(pairs) == logs["num_denoising_steps"] * chunks
    kids = collections.Counter((s.parent, s.name) for s in spans if names.get(s.parent) == "pair_vjp")
    assert kids == {(p.id, n): 1 for p in pairs for n in ("unet_forward", "unet_backward")}
    assert not {"graph_capture", "graph_replay"} & set(names.values())


def _unet(dtype=torch.bfloat16, flash_bwd="split", remat=True):
    return SimpleNamespace(conv_in=SimpleNamespace(weight=torch.empty(0, dtype=dtype)), flash_bwd=flash_bwd,
                           remat=remat)


BASE = dict(unet=_unet(), rows=2, traj=torch.empty(3, 4, 8, 8, 4), context=torch.empty(4, 77, 32, dtype=torch.bfloat16),
            key_mask=torch.empty(4, 77, dtype=torch.int32), weights={"a.to_q.weight": torch.empty(8, 8)},
            guidance_scale=7.5)
CHANGED = {
    "rows": dict(rows=1),
    "latent_shape": dict(traj=torch.empty(3, 4, 16, 16, 4)),
    "context_shape": dict(context=torch.empty(4, 80, 32, dtype=torch.bfloat16)),
    "key_mask": dict(key_mask=None),
    "weight_names": dict(weights={"a.to_k.weight": torch.empty(8, 8)}),
    "weight_shapes": dict(weights={"a.to_q.weight": torch.empty(8, 16)}),
    "no_weights": dict(weights={}),
    "latent_dtype": dict(traj=torch.empty(3, 4, 8, 8, 4, dtype=torch.float64)),
    "context_dtype": dict(context=torch.empty(4, 77, 32)),
    "unet_dtype": dict(unet=_unet(dtype=torch.float32)),
    "flash_bwd": dict(unet=_unet(flash_bwd="merged")),
    "remat": dict(unet=_unet(remat=False)),
    "guidance_scale": dict(guidance_scale=5.0),
}


@pytest.mark.parametrize("field", list(CHANGED))
def test_pair_signature_changes_with_each_field(field):
    assert pair_signature(**BASE) == pair_signature(**BASE)
    assert pair_signature(**{**BASE, **CHANGED[field]}) != pair_signature(**BASE)


def test_pair_signature_ignores_the_step_count_and_the_lanes():
    """A step's denoising steps and its lanes (the trajectory's first two
    axes) set how often the graph replays, not what it holds."""
    assert pair_signature(**{**BASE, "traj": torch.empty(21, 12, 8, 8, 4)}) == pair_signature(**BASE)
