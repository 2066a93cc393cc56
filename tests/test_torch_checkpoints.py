"""fairdiff_torch.training.checkpoints and resume: the dual cadence of the
JAX package's `test_dual_cadence_and_restore` case by case, the AdamW
moments and the update count through a checkpoint, a resumed tiny `fit`
equal bit for bit to an unbroken one on the CPU, and the prompt-order
replay of the JAX `test_resume_replays_prompt_order`."""

import numpy as np
import pytest
import torch

from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion
from fairdiff_torch.training.checkpoints import DualCadenceCheckpointer
from fairdiff_torch.training.debias import DebiasConfig, DebiasState, DebiasTrainer, new_state
from fairdiff_torch.training.synthetic import synthetic_stack
from fairdiff_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

TINY = dict(train_text_encoder=True, train_unet=True, lora_rank=2, train_images_per_prompt=4,
            train_micro_batch=2, steps_low=2, steps_high=2, val_images_per_prompt=2,
            eval_denoising_steps=2, max_train_steps=4, eval_interval=0)
PROMPTS = [(torch.tensor([[0, 5, 6, 63]]), torch.tensor([[0, 63, 1, 1]])),
           (torch.tensor([[0, 9, 63, 63]]), torch.tensor([[0, 63, 1, 1]]))]


def _mk_state(step: int, val: float = 1.0) -> DebiasState:
    adapters = {"te_lora": {"layer": {"down": torch.full((3, 2), val), "up": torch.zeros(2, 3)}}}
    state = new_state(DebiasConfig(learning_rate=1e-4), adapters, torch.device("cpu"))
    state.step = step
    return state


def test_dual_cadence_and_restore(tmp_path):
    ckpt = DualCadenceCheckpointer(tmp_path, tmp_every=2, perm_every=10, tmp_keep=2)
    for step in range(1, 13):
        ckpt.maybe_save(_mk_state(step, float(step)))
    ckpt.wait()
    # tmp keeps only the 2 newest of {2, 4, 6, 8, 12}; 10 went to perm
    assert ckpt.all_steps("perm") == [10]
    assert ckpt.all_steps("tmp") == [8, 12]
    assert ckpt.latest_step() == 12
    assert not list(tmp_path.rglob("*.partial"))
    restored = ckpt.restore(_mk_state(0))
    assert restored.step == 12
    np.testing.assert_array_equal(restored.adapters["te_lora"]["layer"]["down"].detach().numpy(), 12.0)
    r10 = ckpt.restore(_mk_state(0), step=10)
    assert r10.step == 10
    np.testing.assert_array_equal(r10.ema["te_lora"]["layer"]["down"].numpy(), 10.0)
    ckpt.close()
    with pytest.raises(FileNotFoundError):
        DualCadenceCheckpointer(tmp_path / "empty").restore(_mk_state(0))


def test_adamw_moments_and_updates_survive(tmp_path):
    """Two AdamW steps, a checkpoint, a restore into a fresh state: the
    moments, the optimizer's step counts, the update count and the leaves
    are equal, the restored leaves are the optimizer's parameters, and the
    next step from either state gives the same result."""
    g = torch.Generator().manual_seed(0)
    states = []
    for _ in range(2):
        s = _mk_state(0)
        for p in tree_leaves(s.adapters):
            p.data.normal_(generator=torch.Generator().manual_seed(1))
        states.append(s)
    state, other = states
    grads = [[torch.randn(p.shape, generator=g) for p in tree_leaves(state.adapters)] for _ in range(3)]

    def step(s, gs):
        for p, gr in zip(tree_leaves(s.adapters), gs):
            p.grad = gr.clone()
        s.opt.step()
        s.opt.zero_grad(set_to_none=True)
        s.step += 1
        s.updates += 1

    step(state, grads[0])
    step(state, grads[1])
    ckpt = DualCadenceCheckpointer(tmp_path, tmp_every=1)
    ckpt.maybe_save(state)
    back = ckpt.restore(other)
    assert (back.step, back.updates) == (2, 2)
    want, got = state.opt.state_dict(), back.opt.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for i in want["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(want["state"][i][k], got["state"][i][k]), k
    assert [id(p) for p in back.opt.param_groups[0]["params"]] == [id(p) for p in tree_leaves(back.adapters)]
    step(state, grads[2])
    step(back, grads[2])
    for a, b in zip(tree_leaves(state.adapters), tree_leaves(back.adapters)):
        assert torch.equal(a, b)


def _trainer(**overrides) -> DebiasTrainer:
    sd = StableDiffusion(SDConfig.tiny(), device="cpu").init_random(0)
    return DebiasTrainer(sd, synthetic_stack(("gender",), device="cpu"), DebiasConfig(**dict(TINY, **overrides)))


def _recording(trainer: DebiasTrainer) -> list[int]:
    seen: list[int] = []
    real = trainer.train_step

    def step(state, prompt_ids, **kw):
        seen.append(int(prompt_ids[0][0, 1]))
        return real(state, prompt_ids, **kw)

    trainer.train_step = step
    return seen


def test_resumed_fit_equals_unbroken_fit(tmp_path):
    """4 steps of `fit` unbroken against 2 steps, a checkpoint, a restore
    into a fresh trainer's `init_state` and 2 more: adapters, EMA, AdamW
    moments, step, update count and prompt order are equal bit for bit."""
    unbroken = _trainer(output_dir=str(tmp_path / "a"))
    seen_a = _recording(unbroken)
    sa = unbroken.fit(unbroken.init_state(3), PROMPTS)

    first = _trainer(output_dir=str(tmp_path / "b"))
    seen_b = _recording(first)
    ckpt = DualCadenceCheckpointer(tmp_path / "b" / "checkpoints", tmp_every=2, perm_every=0)
    first.fit(first.init_state(3), PROMPTS, max_steps=2, checkpoint_cb=ckpt.maybe_save)
    second = _trainer(output_dir=str(tmp_path / "b"))
    seen_c = _recording(second)
    sb = second.fit(ckpt.restore(second.init_state(3)), PROMPTS, checkpoint_cb=ckpt.maybe_save)

    assert (sa.step, sa.updates) == (sb.step, sb.updates) == (4, 4)
    assert seen_a == seen_b + seen_c and len(seen_a) == 4
    assert ckpt.all_steps("tmp") == [2, 4]
    for a, b in zip(tree_leaves(sa.adapters) + tree_leaves(sa.ema), tree_leaves(sb.adapters) + tree_leaves(sb.ema)):
        assert torch.equal(a, b)
    ma, mb = sa.opt.state_dict()["state"], sb.opt.state_dict()["state"]
    assert ma.keys() == mb.keys()
    for i in ma:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(ma[i][k], mb[i][k])


def test_resume_replays_prompt_order():
    """A run resumed mid-epoch sees the prompt sequence of the unbroken run:
    `fit` fast-forwards the permutation stream through the epochs done."""
    prompts = [(torch.tensor([[i, 63]]), torch.tensor([[0, 63]])) for i in range(3)]

    def run(from_step: int, to_step: int) -> list[int]:
        trainer = _trainer(max_train_steps=to_step)
        seen = []

        def fake_step(state, pid):
            seen.append(int(pid[0][0, 0]))
            return DebiasState(state.adapters, state.opt, state.ema, state.step + 1, state.updates), {}

        trainer.train_step = fake_step
        state = trainer.init_state(1)
        state.step = from_step
        trainer.fit(state, prompts, max_steps=to_step)
        return seen

    unbroken = run(0, 8)
    assert sorted(unbroken[:3]) == sorted(unbroken[3:6]) == [0, 1, 2]
    for start in (1, 3, 5, 7):
        assert run(start, 8) == unbroken[start:]
