"""fairdiff_torch's face-recognition trainer against the JAX package's
(optax's clip_by_global_norm + sgd(momentum) over a piecewise-constant
schedule, weight decay in the loss, the head weight projected back to the
sphere): three `train_step`s from the JAX init on the same batches.

Cases: tiny SFNet with SphereFace (through an lr boundary), CosFace (the
clip fires on the first step), SphereFace+ and SphereFace2 (`head_b` trained), and
tiny IResNet (FrozenBatchNorm's mean and var trained and decayed, as the
JAX package's parameters).

Tolerances: each step's loss within rel 1e-5; after three steps every
trained leaf within rel L2 1e-5 (fp32 sums in other orders); features of
`extract_features` within rel L2 1e-5; the schedule equal to optax's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fairdiff.facerec.trainer import FaceRecConfig as JaxFaceRecConfig
from fairdiff.facerec.trainer import FaceRecTrainer as JaxFaceRecTrainer
from fairdiff.models.iresnet import IResNet as JaxIResNet
from fairdiff.models.iresnet import IResNetConfig as JaxIResNetConfig
from fairdiff.models.sfnet import SFNet as JaxSFNet
from fairdiff.models.sfnet import SFNetConfig as JaxSFNetConfig
from fairdiff_torch.facerec.trainer import FaceRecConfig, FaceRecTrainer
from fairdiff_torch.fairness.margin_heads import sphereface2_bias_init
from fairdiff_torch.io.from_jax import state_dict_from_jax
from fairdiff_torch.models.iresnet import IResNet, IResNetConfig
from fairdiff_torch.models.sfnet import SFNet, SFNetConfig

torch.set_num_threads(1)

BASE = dict(feat_dim=32, num_classes=10, lr=0.1, momentum=0.9, weight_decay=5e-4,
            lr_decay_steps=(40, 60), lr_decay_rate=0.1, clip_grad_norm=1e5)
CASES = {
    "sfnet-sphereface-lr-boundary": ("sfnet", dict(head="sphereface", lr_decay_steps=(2, 60))),
    "sfnet-cosface-clip": ("sfnet", dict(head="cosface", head_kwargs=(("s", 30.0), ("m", 0.2)),
                                         clip_grad_norm=0.05)),
    "sfnet-spherefaceplus": ("sfnet", dict(head="spherefaceplus", head_kwargs=(("lambda_mhe", 0.5),))),
    "sfnet-sphereface2": ("sfnet", dict(head="sphereface2", head_kwargs=(("magn_type", "C"), ("lw", 10.0)))),
    "iresnet-sphereface": ("iresnet", dict(head="sphereface", feat_dim=16)),
}


def _nets(kind):
    if kind == "sfnet":
        return JaxSFNet(JaxSFNetConfig.tiny()), SFNet(SFNetConfig.tiny())
    return JaxIResNet(JaxIResNetConfig.tiny()), IResNet(IResNetConfig.tiny())


def _batches(n, batch=8, size=32, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32), rng.integers(0, classes, batch))
            for _ in range(n)]


def _flat_jax(params):
    out = {f"backbone.{k}": v.numpy() for k, v in state_dict_from_jax(params["backbone"]).items()}
    out.update({k: np.asarray(v) for k, v in params.items() if k != "backbone"})
    return out


def _flat_port(params):
    out = {f"backbone.{k}": v.detach().numpy() for k, v in params["backbone"].items()}
    out.update({k: v.detach().numpy() for k, v in params.items() if k != "backbone"})
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("case", list(CASES))
def test_three_train_steps_match_jax(case):
    kind, over = CASES[case]
    fields = dict(BASE, **over)
    jnet, tnet = _nets(kind)
    jtrainer = JaxFaceRecTrainer(jnet, JaxFaceRecConfig(**fields))
    ttrainer = FaceRecTrainer(tnet, FaceRecConfig(**fields), device="cpu")
    jstate = jtrainer.init_state(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    tstate = ttrainer.init_state(params=jstate["params"])
    start = _flat_port(tstate["params"])
    assert set(start) == set(_flat_jax(jstate["params"]))

    batches = _batches(3)
    if case.endswith("clip"):  # the clip fires on the first step
        total, _ = ttrainer.loss(tstate["params"], torch.tensor(batches[0][0]), torch.tensor(batches[0][1]))
        leaves = [v for k, v in sorted(_leaves(tstate["params"]))]
        norm = torch.sqrt(sum(g.pow(2).sum() for g in torch.autograd.grad(total, leaves)))
        assert norm.item() > 4 * fields["clip_grad_norm"], norm
    for images, labels in batches:
        jstate, jloss = jtrainer.train_step(jstate, jnp.asarray(images), jnp.asarray(labels))
        tstate, tloss = ttrainer.train_step(tstate, images, labels)
        assert abs(tloss - jloss) <= 1e-5 * abs(jloss), (tloss, jloss)
    assert tstate["step"] == jstate["step"] == 3 and tstate["opt"]["count"] == 3

    got, want = _flat_port(tstate["params"]), _flat_jax(jstate["params"])
    for name in want:
        assert _rel(got[name], want[name]) <= 1e-5, (name, _rel(got[name], want[name]))
        if name.endswith((".mean", ".var")):  # trained like the JAX package's parameters
            assert np.abs(got[name] - start[name]).max() > 0, name
    if kind == "iresnet":
        assert any(n.endswith(".var") for n in want)
    if "sphereface2" in case:
        assert "head_b" in got and got["head_b"] != start["head_b"]
    np.testing.assert_allclose(np.linalg.norm(got["head_w"], axis=0), 1.0, rtol=1e-6)

    images = _batches(1, seed=5)[0][0]
    jf = np.asarray(jtrainer.extract_features(jstate, jnp.asarray(images)))
    tf = ttrainer.extract_features(tstate, images).numpy()
    assert _rel(tf, jf) <= 1e-5


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_schedule_matches_optax():
    cfg = FaceRecConfig(lr=0.1, lr_decay_steps=(3, 5, 5), lr_decay_rate=0.1)
    trainer = FaceRecTrainer(SFNet(SFNetConfig.tiny()), cfg, device="cpu")
    sched = optax.piecewise_constant_schedule(0.1, {3: 0.1, 5: 0.1})
    got = [trainer.lr_at(c) for c in range(8)]
    assert got == [float(sched(c)) for c in range(8)]
    assert got[:3] == [np.float32(0.1)] * 3 and got[3] == got[4] != got[5]


def test_seeded_init_and_fit(tmp_path):
    """The seeded init: flax's (lecun-normal kernels, zero biases, BN at
    identity, PReLU 0.25), a unit-column head; `fit` logs loss and times and
    validates on its interval."""
    cfg = FaceRecConfig(head="sphereface2", feat_dim=16, num_classes=10, max_iters=4, val_interval=2)
    trainer = FaceRecTrainer(IResNet(IResNetConfig.tiny()), cfg, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    again = trainer.init_state(torch.Generator().manual_seed(0))
    bb = state["params"]["backbone"]
    assert all(torch.equal(bb[k], again["params"]["backbone"][k]) for k in bb)
    assert torch.all(bb["prelu.alpha"] == 0.25) and torch.all(bb["bn1.var"] == 1) and torch.all(bb["bn1.mean"] == 0)
    assert abs(bb["conv1.weight"].std().item() - 27**-0.5) < 0.05
    torch.testing.assert_close(state["params"]["head_w"].norm(dim=0), torch.ones(10))
    assert state["params"]["head_b"].item() == float(np.float32(sphereface2_bias_init(10)))

    logs = []
    batches = iter(_batches(4, size=32))
    state = trainer.fit(state, batches, log_every=1, logger=lambda s, l: logs.append((s, l)),
                        val_fn=lambda st: {"val": float(st["step"])})
    assert state["step"] == 4
    assert [s for s, l in logs if "loss" in l] == [1, 2, 3, 4]
    assert [l["val"] for s, l in logs if "val" in l] == [2.0, 4.0]
    assert all(l["step_s"] >= l["data_s"] >= 0 for s, l in logs if "loss" in l)
