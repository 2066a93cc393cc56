"""fairdiff_torch.parallel.mesh and the data-parallel trainers against the
JAX package's mesh (the 8 virtual CPU devices of tests/conftest.py).

The port runs one process a device: each multi-rank case spawns 2 or 4 gloo
processes (`parallel.launch.spawn`, a FileStore under tmp_path, a timeout
on every launch) running `torch_ranks`' functions, which import no JAX.

- `MeshConfig.resolve` and `local_slice`: equal to JAX's on a grid;
- the mesh helpers on a 2 x 2 mesh (rows, sums, gathers, broadcast, checks);
- one exp-1 `train_step` of the JAX trainer on a data=2 x model=2 mesh
  (UNet and text-encoder LoRA), run once; the port's step at data=2 and at
  data=2 x model=2 on its draws: every gradient within rel L2 1e-4 (the JAX
  8-device dry run read 1.06e-5 between mesh and single device), targets
  equal, logs within rel 1e-4, adapters and EMA within 1e-6 relative plus
  the AdamW slack `assert_steps_match_jax` states; at data=2 the all-reduce
  equal to the sum of the ranks' own gradients, and each rank's own within
  rel L2 1e-4 of the port's one-process step over that rank's lanes only
  (`chip_smoke.lane_shares`), the ranks' lanes swapped failing that;
- exp-3 at data=2: `ot_draws` equal to the JAX trainer's on a data=2 mesh,
  the gathered targets equal to the port's world-1 targets;
- one `FaceRecTrainer` step at data=2 against the JAX mesh step (SphereFace
  and SphereFace+, whose energy term spans the batch): every leaf within
  rel L2 1e-5; `train_facerec --data_mesh 2` against the JAX CLI's;
- `train_debias` on two processes equal to one process, rank 0 alone
  writing, and `--distributed 1` over a tcp rendezvous.
All fp32.
"""

from __future__ import annotations

import contextlib
import io
import json
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairdiff.adapters import ema as jema
from fairdiff.facerec.trainer import FaceRecConfig as JaxFaceRecConfig
from fairdiff.facerec.trainer import FaceRecTrainer as JaxFaceRecTrainer
from fairdiff.models.sfnet import SFNet as JaxSFNet
from fairdiff.models.sfnet import SFNetConfig as JaxSFNetConfig
from fairdiff.parallel import MeshConfig as JaxMeshConfig
from fairdiff.parallel import create_mesh as jax_create_mesh
from fairdiff.parallel import local_slice as jax_local_slice
from fairdiff.sampling import pipeline as jpipe
from fairdiff.tools import train_facerec as jax_train_facerec
from fairdiff.training import debias as jdebias
from fairdiff.training import synthetic as jsyn
from fairdiff.utils import rng as jrng
from fairdiff_torch.parallel.launch import spawn
from fairdiff_torch.parallel.mesh import MeshConfig, local_slice
from test_torch_facerec_trainer import BASE, _flat_jax, _rel
from test_torch_models import random_tree
from test_torch_trainer import COND, UNCOND, preset_cfg

torch.set_num_threads(1)

TIMEOUT = 240  # seconds a launch may take before its ranks are killed
CFG = dict(train_text_encoder=True, train_unet=True, lora_rank=2, train_images_per_prompt=4,
           train_micro_batch=2, steps_low=2, steps_high=2)


def _spawn(tmp_path, target, world, **kwargs):
    return spawn(f"torch_ranks:{target}", world, backend="gloo", kwargs=kwargs, workdir=tmp_path,
                 timeout=TIMEOUT, device="cpu")


def test_spawn_defaults_to_the_cards(tmp_path, monkeypatch):
    """`spawn` with no device resolves it as every entry point does: to
    CUDA, so where there is none it raises before it starts a rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn("torch_ranks:mesh_ops", 2, backend="gloo", workdir=tmp_path / "w", timeout=TIMEOUT)
    assert not (tmp_path / "w").exists()


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12])
@pytest.mark.parametrize("data, model", [(-1, 1), (-1, 2), (2, 2), (4, 2), (3, 2), (0, 4), (2, 0), (8, 1)])
def test_mesh_config_resolve_matches_jax(n, data, model):
    want = got = None
    try:
        want = JaxMeshConfig(data=data, model=model).resolve(n)
    except ValueError as e:
        want = str(e)
    try:
        got = MeshConfig(data=data, model=model).resolve(n)
    except ValueError as e:
        got = str(e)
    assert got == want


@pytest.mark.parametrize("n", [1, 5, 7, 8, 24])
@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_local_slice_matches_jax(n, size):
    assert [local_slice(n, size, i) for i in range(size)] == [jax_local_slice(n, size, i) for i in range(size)]


def test_mesh_helpers_on_four_ranks(tmp_path):
    out = _spawn(tmp_path, "mesh_ops", 4)
    # row-major: the model axis innermost, as the JAX mesh reshapes its devices
    assert [(r["data"], r["model"]) for r in out] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in out:
        rows = jax_local_slice(5, 2, r["data"])
        assert torch.equal(r["shard"][0], torch.arange(10).reshape(5, 2)[rows])
        np.testing.assert_array_equal(r["shard"][1], np.arange(5)[rows])
        same_model = [q["rank"] for q in out if q["model"] == r["model"]]
        same_data = [q["rank"] for q in out if q["data"] == r["data"]]
        assert r["sum_data"].dtype == torch.bfloat16
        assert r["sum_data"].tolist() == [float(sum(same_model)), 2.0]
        assert r["sum_model"].tolist() == [float(sum(same_data)), 2.0]
        assert r["sum_tree"]["b"]["c"].tolist() == [float(sum(same_model))] * 3
        assert r["gather_f"].tolist() == [0.0, 2.0, 4.0, 6.0, 8.0]
        assert r["gather_b"].tolist() == [True, False, True, False, True]
        assert r["gather_i"].tolist() == [10, 11, 12, 13, 14]
        assert r["replicated"].tolist() == [float(r["model"])] * 3  # data-rank 0 of its model column
        assert "runs gloo, not nccl" in r["backend_error"]
        assert r["tiling_error"] == "mesh 3x2 does not tile 4 devices"


def test_gather_rows_grad_is_the_loss_gradient(tmp_path):
    out = _spawn(tmp_path, "gather_grad", 2)
    x = torch.arange(4.0) + 1
    for r, (full, grad) in enumerate(out):
        assert torch.equal(full, x)
        assert torch.equal(grad, 3 * x[2 * r: 2 * r + 2] ** 2)


@pytest.fixture(scope="module")
def jax_mesh_step():
    """One exp-1 step of the JAX trainer on a data=2 x model=2 mesh (4 of
    the virtual devices), its inputs and results as numpy."""
    jsd = jpipe.StableDiffusion(jpipe.SDConfig.tiny())
    params = random_tree(jax.eval_shape(jsd.init_params, jax.random.key(0)), seed=3)
    jstack = jsyn.synthetic_stack(("gender",))
    mesh = jax_create_mesh(JaxMeshConfig(data=2, model=2), devices=jax.devices()[:4])
    jtr = jdebias.DebiasTrainer(jsd, params, jstack, jdebias.DebiasConfig(**CFG), mesh=mesh)
    jtr.keep_pair_inputs = True
    state = jtr.init_state(jax.random.key(1))
    rng = np.random.default_rng(8)
    adapters = jax.tree_util.tree_map_with_path(
        lambda path, x: (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        if path[-1].key == "up" else np.asarray(x), state.adapters)
    state = jdebias.DebiasState(adapters, jtr.tx.init(adapters), jema.init_ema(adapters), 0)
    key = jax.random.key(42)
    new, logs = jtr.train_step(state, (jnp.asarray(COND), jnp.asarray(UNCOND)), key)
    get = lambda tree: [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
    return {
        "params": jax.device_get(params), "db_feats": np.asarray(jstack.face_db.feats), "adapters": adapters,
        "noises": np.asarray(jtr._last_pair_inputs["noises"]),
        "n_steps": jrng.sample_num_denoising_steps(key, 0, CFG["steps_low"], CFG["steps_high"]),
        "targets": {a: np.asarray(v) for a, v in jtr._last_pair_inputs["targets"].items()},
        "grads": get(jtr._last_grads), "new_adapters": get(new.adapters), "ema": get(new.ema), "logs": logs,
    }


@pytest.mark.parametrize("data, model", [(2, 1), (2, 2)])
def test_mesh_train_step_matches_jax_mesh_trainer(tmp_path, jax_mesh_step, data, model):
    j = jax_mesh_step
    out = _spawn(tmp_path, "debias_step", data * model, data=data, model=model, cfg=CFG, params=j["params"],
                 db_feats=j["db_feats"], adapters=j["adapters"], noises=j["noises"], n_steps=j["n_steps"],
                 ids=(COND, UNCOND))
    assert all(r["sharded"] == (model > 1) for r in out)
    lr = CFG.get("learning_rate", jdebias.DebiasConfig().learning_rate)
    norm = lambda g: np.asarray(g, np.float64) / (np.abs(np.asarray(g, np.float64)) + 1e-8)
    for r in out:  # every rank holds the same global step
        assert set(r["targets"]) == set(j["targets"])
        for a, v in j["targets"].items():
            np.testing.assert_array_equal(r["targets"][a].numpy(), v)
        assert len(r["grads"]) == len(j["grads"]) > 0 and any(np.abs(g).max() > 0 for g in j["grads"])
        for t, w in zip(r["grads"], j["grads"]):
            assert _rel(t.numpy(), w) < 1e-4
        # AdamW's first update is ~lr * sign(g): an element whose gradient
        # sits near eps moves by what the two sides' gradients explain
        slack = [lr * np.abs(norm(t.numpy()) - norm(w)) for t, w in zip(r["grads"], j["grads"])]
        for got, want in ((r["adapters"], j["new_adapters"]), (r["ema"], j["ema"])):
            for t, w, sl in zip(got, want, slack):
                assert np.all(np.abs(t.numpy() - w) <= 1e-7 + 1e-6 * np.abs(w) + sl)
        assert set(r["logs"]) - {"grads_finite"} == set(j["logs"])
        for k, v in j["logs"].items():
            assert r["logs"][k] == pytest.approx(v, rel=1e-4, abs=1e-7), k
    if model == 1:
        # the all-reduce is the sum of the ranks' own gradients, and either
        # rank's alone (no all-reduce) breaks the 1e-4 check
        for t, a, b in zip(out[0]["grads"], out[0]["local"], out[1]["local"]):
            assert torch.equal(t, a + b)
        for r in out:
            assert max(_rel(t.numpy(), w) for t, w in zip(r["local"], j["grads"])) > 1e-4
        # each rank's own gradients against the one-process step over that
        # rank's lanes only (its pair VJPs on those lanes alone); swapping
        # the ranks' lanes breaks the check
        from torch_ranks import debias_step  # in this process: no mesh at 1 x 1

        one = debias_step(data=1, model=1, cfg=CFG, params=j["params"], db_feats=j["db_feats"],
                          adapters=j["adapters"], noises=j["noises"], n_steps=j["n_steps"], ids=(COND, UNCOND),
                          lane_spans=[slice(0, 2), slice(2, 4)])
        assert all(s.norm() > 0 for s in one["shares"])
        for r in range(2):
            own = torch.cat([g.flatten() for g in out[r]["local"]])
            assert _rel(own.numpy(), one["shares"][r].numpy()) < 1e-4
            assert _rel(own.numpy(), one["shares"][1 - r].numpy()) > 1e-4


def test_exp3_targets_gathered_over_the_data_axis(tmp_path):
    """exp-3 at data=2: the OT draws scale with the data shards as the JAX
    trainer's do, and the targets solved from the gathered probabilities
    equal the world-1 targets at the same total draws."""
    jsd = jpipe.StableDiffusion(jpipe.SDConfig.tiny())
    params = random_tree(jax.eval_shape(jsd.init_params, jax.random.key(0)), seed=3)
    cfg = preset_cfg("exp3", uncertainty_thresholds=(0.4, 0.4), ot_num_samples=0)
    jtr = jdebias.DebiasTrainer(jsd, params, jsyn.synthetic_stack(cfg["attributes"]), jdebias.DebiasConfig(**cfg),
                                mesh=jax_create_mesh(JaxMeshConfig(data=2, model=1), devices=jax.devices()[:2]))
    adapters = {"te_lora": jax.device_get(jtr.init_state(jax.random.key(1)).adapters["te_lora"])}
    noises = np.random.default_rng(4).normal(size=(4, 8, 8, 4)).astype(np.float32)
    common = dict(params=jax.device_get(params), db_feats=None, adapters=adapters, noises=noises, n_steps=2,
                  ids=(COND, UNCOND))
    (one,) = _spawn(tmp_path, "debias_step", 1, data=1, model=1,
                    cfg=dict(cfg, ot_samples_per_shard=cfg["ot_samples_per_shard"] * 2), **common)
    two = _spawn(tmp_path, "debias_step", 2, data=2, model=1, cfg=cfg, **common)
    assert one["ot_draws"] == two[0]["ot_draws"] == jtr.ot_draws == 2 * cfg["ot_samples_per_shard"]
    for r in two:
        assert set(r["targets"]) == {"gender", "race"}
        for a, t in one["targets"].items():
            assert torch.equal(r["targets"][a], t)
    assert any((t != -1).any() for t in one["targets"].values())


FACEREC_CASES = {
    "sphereface": dict(head="sphereface"),
    "spherefaceplus": dict(head="spherefaceplus", head_kwargs=(("lambda_mhe", 0.5),)),
}


@pytest.mark.parametrize("case", list(FACEREC_CASES))
def test_facerec_data_mesh_step_matches_jax(tmp_path, case):
    fields = dict(BASE, **FACEREC_CASES[case])
    jtr = JaxFaceRecTrainer(JaxSFNet(JaxSFNetConfig.tiny()), JaxFaceRecConfig(**fields),
                            mesh=jax_create_mesh(JaxMeshConfig(data=2, model=1), devices=jax.devices()[:2]))
    jstate = jtr.init_state(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    init = jax.device_get(jstate["params"])
    rng = np.random.default_rng(0)
    batches = [(rng.uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32), rng.integers(0, 10, 8)) for _ in range(2)]
    jlosses = []
    for images, labels in batches:
        jstate, loss = jtr.train_step(jstate, jnp.asarray(images), jnp.asarray(labels))
        jlosses.append(loss)
    want = _flat_jax(jax.device_get(jstate["params"]))
    out = _spawn(tmp_path, "facerec_step", 2, data=2, kind="sfnet", fields=fields, params=init, batches=batches)
    for r in out:
        assert set(r["params"]) == set(want)
        for name, w in want.items():
            assert _rel(r["params"][name].numpy(), w) <= 1e-5, name
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5)


def test_train_facerec_data_mesh_matches_jax_cli(tmp_path):
    """The port's CLI on two processes against the JAX CLI on its 8-device
    data mesh (one row a device; its mesh must tile every device)."""
    from test_torch_facerec_cli import _train_tree

    data = _train_tree(tmp_path)
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(f"""
data:
  train:
    dataset: {{type: ClassDataset, data_dir: {data}, ann_path: {tmp_path}/ann.txt}}
    batch_size: 8
model:
  backbone: {{type: sfnet4, out_channel: 8, in_size: 32}}
  head: {{type: CosFace, s: 8.0, m: 0.1}}
trainer: {{lr: 0.05, max_iters: 3, lr_decay_steps: [2]}}
""")
    jcli = jax_train_facerec.FaceRecCLIConfig(config=str(cfg), output_dir=str(tmp_path / "jax"), save_every=2,
                                              log_every=1, data_mesh=8)
    jtrainer, *_ = jax_train_facerec.build_all(jcli)
    init = jax.device_get(jtrainer.init_state(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"])
    with contextlib.redirect_stdout(io.StringIO()):
        jax_train_facerec.main(jcli)
    steps = _spawn(tmp_path, "facerec_cli", 2, config=str(cfg), out=str(tmp_path / "port"), init_params=init,
                   data_mesh=2)
    assert steps == [3, 3]
    assert not (tmp_path / "port" / "rank1").exists()  # only rank 0 writes
    for name in ("backbone_2.npz", "backbone_final.npz"):
        got, want = np.load(tmp_path / "port" / "rank0" / name), np.load(tmp_path / "jax" / name)
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert _rel(got[key], want[key]) <= 1e-5, (name, key)
    losses = lambda p: [json.loads(x)["loss"] for x in p.read_text().splitlines() if '"loss"' in x]
    assert _rel(losses(tmp_path / "port" / "rank0" / "metrics.jsonl"), losses(tmp_path / "jax" / "metrics.jsonl")) <= 1e-5


def _argv(out, *extra):
    return ["--device", "cpu", "--tiny_smoke", "1", "--max_train_steps", "2", "--checkpoint_tmp_every", "1",
            "--output_dir", str(out), *extra]


def test_train_debias_cli_on_two_processes(tmp_path):
    """`--mesh_data 0` (the world divided by the model axis) on two ranks:
    the adapters equal one process's within fp32 summation noise; rank 0
    writes the metrics, checkpoints and exports (one output directory)."""
    (one,) = _spawn(tmp_path, "debias_cli", 1, argv=_argv(tmp_path / "one"))
    two = _spawn(tmp_path, "debias_cli", 2, argv=_argv(tmp_path / "two", "--mesh_data", "0"))
    for r in two:
        for a, b in zip(r, one):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    records = (tmp_path / "two" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in records] == [1, 2]
    assert sorted(p.name for p in (tmp_path / "two" / "checkpoints" / "tmp").iterdir()) == ["1.pt", "2.pt"]
    assert (tmp_path / "two" / "exported" / "te_lora.npz").exists()


def test_train_debias_distributed_flag_joins_over_tcp(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.run(
        [sys.executable, "-m", "fairdiff_torch.tools.train_debias", *_argv(tmp_path, "--max_train_steps", "1"),
         "--distributed", "1", "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", "1",
         "--process_id", "0"],
        capture_output=True, text=True, timeout=TIMEOUT, env={**__import__("os").environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[distributed] process 0/1 on gloo" in proc.stdout
    assert [json.loads(x)["step"] for x in proc.stdout.splitlines() if x.startswith("{")] == [1]
