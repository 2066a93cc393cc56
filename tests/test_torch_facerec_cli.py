"""fairdiff_torch's face-recognition CLIs against the JAX package's:
`train_facerec` for three steps from the JAX init on the same tree (the
native batch stream, validation and checkpoints), a shipped recipe through
`base.yml` (which the JAX CLI rejects), `eval_facerec` on a PairDataset and
an IJBDataset, and `create_facerec_list`.

Tolerances: the final backbone `.npz` and every logged loss within rel
1e-5; the validation and evaluation metrics (percentages) within 1e-6 and
the printed rows equal; the list file byte-equal.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fairdiff.io.adapters_io import load_adapters as jax_load_adapters
from fairdiff.io.adapters_io import save_adapters as jax_save_adapters
from fairdiff.tools import create_facerec_list as jax_create
from fairdiff.tools import eval_facerec as jax_eval
from fairdiff.tools import train_facerec as jax_train
from fairdiff_torch.facerec.builder import CONFIG_DIR
from fairdiff_torch.io.adapters_io import load_adapters
from fairdiff_torch.io.images import write_png
from fairdiff_torch.tools import create_facerec_list, eval_facerec, train_facerec

torch.set_num_threads(1)

SRC_LANDMARK = [[38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
                [41.5493, 92.3655], [70.7299, 92.2041]]


def _images(root, n, size, seed=0, classes=4):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        write_png(rng.integers(0, 256, (size, size, 3), dtype=np.uint8), root / f"im{i}.png")
        lines.append(f"im{i}.png {i % classes}")
    return lines


def _train_tree(tmp_path):
    data = tmp_path / "data"
    (tmp_path / "ann.txt").write_text("\n".join(_images(data, 12, 32)))
    (tmp_path / "pairs.txt").write_text("im0.png im4.png 1\nim0.png im1.png 0\nim2.png im6.png 1\nim3.png im5.png 0\n")
    return data


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_train_facerec_matches_jax_cli(tmp_path):
    data = _train_tree(tmp_path)
    (tmp_path / "backbone_base.yml").write_text("type: sfnet4\nout_channel: 16\nin_size: 32\n")
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(f"""
data:
  train:
    dataset: {{type: ClassDataset, data_dir: {data}, ann_path: {tmp_path}/ann.txt}}
    batch_size: 4
  val:
    dataset: {{type: PairDataset, data_dir: {data}, ann_path: {tmp_path}/pairs.txt}}
model:
  backbone: {{base: {tmp_path}/backbone_base.yml, out_channel: 8}}
  head: {{type: CosFace, s: 8.0, m: 0.1}}
trainer: {{lr: 0.05, max_iters: 3, val_interval: 2, lr_decay_steps: [2]}}
""")
    jcli = jax_train.FaceRecCLIConfig(config=str(cfg), output_dir=str(tmp_path / "jax"), save_every=2, log_every=1)
    jtrainer, *_ = jax_train.build_all(jcli)
    init = jtrainer.init_state(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    with contextlib.redirect_stdout(io.StringIO()):
        jstate = jax_train.main(jcli)
    tcli = train_facerec.FaceRecCLIConfig(device="cpu", config=str(cfg), output_dir=str(tmp_path / "port"),
                                          save_every=2, log_every=1)
    tstate = train_facerec.main(tcli, init_params=init)
    assert tstate["step"] == jstate["step"] == 3

    for name in ("backbone_2.npz", "backbone_final.npz"):
        got, want = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert _rel(got[key], want[key]) <= 1e-5, (name, key)
    # the port's file is the JAX layout: the JAX loader reads it and the JAX net runs it
    tree = jax_load_adapters(tmp_path / "port" / "backbone_final.npz")
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(jax.device_get(jstate["params"]["backbone"]))

    jrec, trec = _records(tmp_path / "jax" / "metrics.jsonl"), _records(tmp_path / "port" / "metrics.jsonl")
    jloss = [r["loss"] for r in jrec if "loss" in r]
    tloss = [r["loss"] for r in trec if "loss" in r]
    assert len(tloss) == len(jloss) == 3 and _rel(tloss, jloss) <= 1e-5
    jval = [r for r in jrec if "EER" in r]
    tval = [r for r in trec if "EER" in r]
    assert len(tval) == len(jval) == 1 and tval[0]["step"] == 2
    for key in jval[0]:
        if key not in ("step", "time"):
            assert abs(tval[0][key] - jval[0][key]) <= 1e-6, key
    assert all("step_s" in r and "data_s" in r for r in trec if "loss" in r)


def test_train_facerec_runs_a_shipped_recipe(tmp_path):
    """vggface2_sfnet20_sphereface.yml through `base.yml`, its data and width
    overridden (the trainer block, `lr_decay_gamma` included, comes from
    base.yml): the port trains; the JAX CLI raises TypeError on it."""
    data = _train_tree(tmp_path)
    recipe = yaml.safe_load((CONFIG_DIR / "vggface2_sfnet20_sphereface.yml").read_text())
    recipe["base"] = str(CONFIG_DIR / recipe["base"])
    recipe["data"] = {"train": {"dataset": {"type": "ClassDataset", "data_dir": str(data),
                                            "ann_path": str(tmp_path / "ann.txt")}, "batch_size": 4}}
    recipe["model"]["backbone"] = {"type": "sfnet4_deprecated", "out_channel": 8, "in_size": 32}
    recipe["trainer"] = {"max_iters": 2}
    cfg = tmp_path / "recipe.yml"
    cfg.write_text(yaml.safe_dump(recipe))

    cli = train_facerec.FaceRecCLIConfig(device="cpu", config=str(cfg), output_dir=str(tmp_path / "out"))
    trainer, *_ = train_facerec.build_all(cli)
    assert trainer.cfg.lr_decay_rate == 0.1 and trainer.cfg.lr_decay_steps == (40000, 60000, 70000)
    assert trainer.cfg.head == "sphereface" and dict(trainer.cfg.head_kwargs) == {"s": 30.0, "m": 1.5}
    with contextlib.redirect_stdout(io.StringIO()):
        state = train_facerec.main(cli)
    assert state["step"] == 2 and (tmp_path / "out" / "backbone_final.npz").exists()

    with pytest.raises(TypeError, match="lr_decay_gamma"):
        jax_train.build_all(jax_train.FaceRecCLIConfig(config=str(cfg), output_dir=str(tmp_path / "jax")))
    # --data_mesh 2 wants a process group of two (torchrun, parallel.launch)
    with pytest.raises(RuntimeError, match="torchrun"):
        train_facerec.build_all(train_facerec.FaceRecCLIConfig(device="cpu", config=str(cfg), data_mesh=2))


def _eval_tree(tmp_path):
    """A pair list over 112x112 faces and an IJB layout beside it."""
    rng = np.random.default_rng(3)
    data = tmp_path / "val"
    _images(data, 10, 112, seed=4)
    pairs = [f"im{a}.png im{b}.png {int(rng.random() > 0.5)}" for a, b in rng.integers(0, 10, (16, 2))]
    (tmp_path / "pairs.txt").write_text("\n".join(pairs) + "\n")
    meta = tmp_path / "meta"
    meta.mkdir()
    data_lines, tid_lines = [], []
    for i in range(12):
        write_png(rng.integers(0, 256, (120, 110, 3), dtype=np.uint8), tmp_path / "ijb" / f"{i}.png")
        lm = np.asarray(SRC_LANDMARK) + rng.uniform(-4, 4, 2) + rng.normal(0, 0.5, (5, 2))
        data_lines.append(f"{i}.png " + " ".join(f"{v:.3f}" for v in lm.reshape(-1)) + f" {rng.uniform(0.5, 1):.3f}")
        tid_lines.append(f"{i}.png {i % 4} {i % 6}")
    (meta / "data.txt").write_text("\n".join(data_lines))
    (meta / "tid.txt").write_text("\n".join(tid_lines))
    (meta / "g.csv").write_text("T,S\n0,0\n1,1\n")
    (meta / "p.csv").write_text("T,S\n2,0\n3,1\n")
    (meta / "pairs.txt").write_text("0 2 1\n1 3 1\n0 3 0\n1 2 0\n")
    cfg = {
        "data": {"val": [
            {"dataset": {"type": "PairDataset", "name": "LFW-like", "data_dir": str(data),
                         "ann_path": str(tmp_path / "pairs.txt")}},
            {"dataset": {"type": "IJBDataset", "name": "IJB-like", "data_dir": str(tmp_path / "ijb"),
                         "meta_dir": str(meta), "data_ann_file": "data.txt", "tmpl_ann_file": "tid.txt",
                         "gallery_ann_files": ["g.csv"], "probe_ann_files": ["p.csv"],
                         "pair_ann_file": "pairs.txt", "src_landmark": SRC_LANDMARK}},
        ]},
        "model": {"backbone": {"type": "sfnet4", "out_channel": 8, "in_size": 112}},
    }
    path = tmp_path / "eval.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_eval_facerec_matches_jax(tmp_path):
    cfg = _eval_tree(tmp_path)
    net = jax_eval.build_backbone({"type": "sfnet4", "out_channel": 8, "in_size": 112})
    jax_save_adapters(tmp_path / "w.npz", net.init(jax.random.key(1), jnp.zeros((1, 112, 112, 3)))["params"])
    out_j, out_t = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out_j):
        want = jax_eval.main(jax_eval.EvalFaceRecCLIConfig(config=str(cfg), weights=str(tmp_path / "w.npz"),
                                                           batch_size=5))
    with contextlib.redirect_stdout(out_t):
        got = eval_facerec.main(eval_facerec.EvalFaceRecCLIConfig(device="cpu", config=str(cfg),
                                                                  weights=str(tmp_path / "w.npz"), batch_size=5))
    assert list(got) == list(want) == ["LFW-like", "IJB-like"]
    for name in want:
        assert [k for k, _ in got[name]] == [k for k, _ in want[name]]
        for (k, g), (_, w) in zip(got[name], want[name]):
            assert abs(g - w) <= 1e-6, (name, k, g, w)
    assert out_t.getvalue() == out_j.getvalue()
    assert load_adapters(tmp_path / "w.npz").keys() == {"layer1_0", "layer2_0", "layer3_0", "layer4_0", "fc"}


@pytest.mark.parametrize("relative", [True, False])
def test_create_facerec_list_is_byte_equal(tmp_path, relative):
    root = tmp_path / "train"
    for cls in ("id_b", "id_a", "id_c/nested"):
        for name in ("img1.JPG", "img0.png", "notes.txt", "img2.jpeg", "x.bmp"):
            (root / cls).mkdir(parents=True, exist_ok=True)
            (root / cls / name).write_bytes(b"")
    (root / "stray.png").write_bytes(b"")
    outs = {}
    for tag, mod in (("jax", jax_create), ("port", create_facerec_list)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            path = mod.create_list(mod.CreateListConfig(dataset_dir=str(root), list_path=str(tmp_path / f"{tag}.txt"),
                                                        relative=relative))
        outs[tag] = (path.read_bytes(), buf.getvalue().replace(str(path), "<list>"))
    assert outs["port"] == outs["jax"]
    assert len(outs["port"][0].splitlines()) == 12
