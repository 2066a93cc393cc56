"""Phase 4b's pair VJPs replayed as CUDA graphs (`DebiasTrainer._pair_grads`,
`PairGraph`) against the eager route, on the card. Marked `gpu`: they skip
where there is no CUDA device (a CUDA graph has no CPU mode) and run on the
card with `python -m pytest --noconftest -m gpu tests/test_torch_pair_graph_gpu.py`.

The tiny SD in bf16 with remat at 64x64 latents (the same 10 flash sites and
16 feed-forwards as SD-1.5's UNet), 4 lanes, micro-batch 2, 2 denoising
steps: 4 pair VJPs a step, of one signature. Two `train_step`s with an AdamW
update between them (a learning rate of 1e-2, so that the update moves the
bf16 merged weights) and another prompt in the second step: a graph that
kept the first step's context or merged weights would give the second step
other gradients. Both routes run the same kernels on the same operands and
sum the cotangents in fp32 in the same order, so with flash_bwd="split" they
are expected bit-equal; the limit is rel L2 1e-3. The kernel launch
counters count the same launches a step on both routes: a replay's launches
are added where the graph replays, and the capture counts none.
"""

import dataclasses

import pytest
import torch

from fairdiff_torch.adapters import lora as lora_lib
from fairdiff_torch.models.unet2d import UNetConfig
from fairdiff_torch.ops import launch_counts
from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion
from fairdiff_torch.training.debias import DebiasTrainer, EagerPairTrainer
from fairdiff_torch.training.presets import PRESETS
from fairdiff_torch.training.synthetic import synthetic_stack
from fairdiff_torch.utils import profiling
from fairdiff_torch.utils.tree import tree_leaves, tree_map

pytestmark = pytest.mark.gpu

REL_L2 = 1e-3
PROMPTS = [(torch.tensor([[0, 5, 6, 63]]), torch.tensor([[0, 63, 1, 1]])),
           (torch.tensor([[0, 9, 2, 63]]), torch.tensor([[0, 63, 1, 1]]))]
# adapters that train: the text-encoder LoRA (exp-1), the UNet LoRA, the prefix (exp-2)
ROUTES = {
    "te_lora": ("exp1", {}),
    "unet_lora": ("exp1", {"train_text_encoder": False, "train_unet": True}),
    "prefix": ("exp2", {}),
}


@pytest.fixture(scope="module")
def sd():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(SDConfig.tiny(), unet=dataclasses.replace(UNetConfig.tiny(), sample_size=64),
                              dtype="bfloat16")
    return StableDiffusion(cfg, device="cuda", remat=True).init_random(0)


def _flat(tree) -> torch.Tensor:
    return torch.cat([x.detach().float().flatten() for x in tree_leaves(tree)])


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("route", list(ROUTES))
def test_graphed_pair_grads_equal_the_eager_route_over_two_steps(sd, route):
    preset, fields = ROUTES[route]
    cfg = PRESETS[preset](lora_rank=2, train_images_per_prompt=4, train_micro_batch=2, steps_low=2, steps_high=2,
                          learning_rate=1e-2, **fields)
    stack = synthetic_stack(cfg.attributes, device=sd.device)
    graphed, eager = DebiasTrainer(sd, stack, cfg), EagerPairTrainer(sd, stack, cfg)
    adapters = graphed.init_state(0).adapters
    if route == "unet_lora":  # `up` non-zero, so every merged weight and its gradient moves
        g = torch.Generator().manual_seed(1)
        adapters = tree_map(lambda x: torch.randn(x.shape, generator=g).cuda() * 0.1 if x.abs().max() == 0 else x,
                            adapters)
    states = {"graphed": graphed.init_state(adapters=adapters), "eager": eager.init_state(adapters=adapters)}
    for step, ids in enumerate(PROMPTS):
        before = tree_map(lambda x: x.detach().clone(), states["graphed"].adapters)
        grads, launched = {}, {}
        for name, trainer in (("graphed", graphed), ("eager", eager)):
            counts = launch_counts()
            states[name], logs = trainer.train_step(states[name], ids)
            launched[name] = {k: n - counts[k] for k, n in launch_counts().items()}
            assert logs["grads_finite"] and logs["grad_norm"] > 0
            grads[name] = _flat(trainer._last_grads)
            if name == "graphed":
                root = profiling.recorded_spans()[-1]
                assert (root.name, root.key) == ("train_step", step)
                spans = [s for s in profiling.recorded_spans() if s.root == root.id]
        err = _rel_l2(grads["graphed"], grads["eager"])
        print(f"[{route}] step {step}: gradients rel L2 {err:.3e}, bit-equal {torch.equal(*grads.values())}")
        assert err <= REL_L2
        assert launched["graphed"] == launched["eager"] and launched["eager"]["geglu_dx"] > 0
        assert len(graphed._pair_graphs) == 1 and not eager._pair_graphs
        (entry,) = graphed._pair_graphs.values()
        if route == "unet_lora":  # the step's merged weights were copied in
            merged = lora_lib.apply_lora(sd.unet, before["unet_lora"])
            assert all(torch.equal(entry.weights[k], w) for k, w in merged.items())
        pairs = sorted((s for s in spans if s.name == "pair_vjp"), key=lambda s: s.t0_ns)
        assert len(pairs) == 2 * 2
        kids = [sorted(s.name for s in spans if s.parent == p.id) for p in pairs]
        if step == 0:  # the first pair warms up and captures, the others replay
            assert kids == [["graph_capture"]] + [["graph_replay"]] * 3
        else:
            assert kids == [["graph_replay"]] * 4
            assert not any(s.name == "unet_forward" for s in spans)
            assert all(s.device_ns is not None and s.device_ns > 0 for s in pairs)
    start = _flat(adapters)  # the two updates of each route
    assert _rel_l2(_flat(states["graphed"].adapters) - start, _flat(states["eager"].adapters) - start) <= REL_L2


def test_model_spans_record_no_event_under_a_graph_capture(sd):
    """A UNet call captured in a CUDA graph: its 16 "transformer_stack" spans
    are recorded with no CUDA event (their device duration stays None) and
    the recorder's event pool does not grow while the stream captures; the
    replay runs, and an eager call's spans read their device durations."""
    g = torch.Generator(device="cuda").manual_seed(0)
    lat2 = torch.randn(2, 64, 64, 4, generator=g, device="cuda")
    ctx = torch.randn(2, 4, sd.config.unet.cross_attention_dim, generator=g, device="cuda").to(sd.dtype)
    t = torch.full((2,), 500, device="cuda")  # a host timestep would be copied during the capture
    stacks = lambda spans: [s for s in spans if s.name == "transformer_stack"]
    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            sd.unet_eps(lat2, t, ctx)  # warm-up off the capturing stream
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        made, before = profiling.RECORDER._made, profiling.recorded_spans()[-1].id
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = sd.unet_eps(lat2, t, ctx)
        captured = stacks(s for s in profiling.recorded_spans() if s.id > before)
        assert len(captured) == 16 and all(s.device_ns is None for s in captured)
        assert profiling.RECORDER._made == made
        graph.replay()
        want = sd.unet_eps(lat2, t, ctx)
        torch.cuda.synchronize()
    assert torch.equal(out, want)
    eager = stacks(profiling.recorded_spans())[-16:]
    assert all(s.device_ns is not None and s.device_ns > 0 for s in eager)
