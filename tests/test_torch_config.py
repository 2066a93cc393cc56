"""fairdiff_torch.utils.config against fairdiff.utils.config: the same YAML
files and CLI arguments onto each package's dataclasses give equal
`to_dict`s and unknown keys raise in both. Exact comparisons."""

import dataclasses
from typing import Optional

import pytest
import torch

from fairdiff.training.debias import DebiasConfig as JDebiasConfig
from fairdiff.utils import config as jconfig
from fairdiff_torch.tools import train_debias
from fairdiff_torch.training.debias import DebiasConfig as TDebiasConfig
from fairdiff_torch.utils import config as tconfig

torch.set_num_threads(1)


@dataclasses.dataclass(frozen=True)
class Inner:
    rate: float = 0.5
    names: tuple[str, ...] = ("a",)


@dataclasses.dataclass(frozen=True)
class Outer:
    steps: int = 1
    cap: Optional[int] = None
    scale: Optional[float] = 2.0
    weights: list[float] = dataclasses.field(default_factory=lambda: [1.0])
    flag: bool = False
    inner: Inner = Inner()


YAMLS = {
    "lists and coercion": "train_unet: yes\nlora_rank: '8'\nattributes: [gender, race]\n"
                          "factor1: [0.2, 0.6]\nuncertainty_thresholds: [0.2, 0.2]\ntarget_kind: ot2\n",
    "comma lists": "attributes: 'gender,race,age'\nfactor2: '0.2, 0.3,0.3'\nlearning_rate: 1e-4\n",
    "empty": "",
    "json syntax": '{"train_text_encoder": false, "train_prefix": true, "eval_interval": 2}\n',
    "yaml booleans and floats": "train_unet: on\nno_face_img_weight_one: no\nface_search_all_lanes: 'yes'\n"
                                "learning_rate: 5.0e-5\nmax_train_steps: 12\n",
}


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_yaml_onto_debias_config_matches_jax(tmp_path, name):
    path = tmp_path / "run.yaml"
    path.write_text(YAMLS[name])
    want = jconfig.to_dict(jconfig.load_yaml(JDebiasConfig(), path))
    got = tconfig.to_dict(tconfig.load_yaml(TDebiasConfig(), path))
    assert got == want


def test_unknown_keys_raise_in_both(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("train_unet: true\nlora_rnak: 4\n")
    for lib, cls in ((jconfig, JDebiasConfig), (tconfig, TDebiasConfig)):
        with pytest.raises(KeyError):
            lib.load_yaml(cls(), path)
        with pytest.raises(KeyError):
            lib.merge(cls(), {"nope": 1})
        with pytest.raises(KeyError):
            lib.from_dict(Outer, {"inner": {"rate": 1.0, "extra": 2}})


@pytest.mark.parametrize("overrides", [
    {"cap": 3, "scale": None, "weights": "0.5,0.25", "flag": "on", "inner": {"names": "x,y", "rate": "0.1"}},
    {"cap": None, "weights": [1, 2], "flag": 0, "steps": "7"},
])
def test_optional_lists_and_nested_match_jax(overrides):
    assert tconfig.to_dict(tconfig.merge(Outer(), overrides)) == jconfig.to_dict(jconfig.merge(Outer(), overrides))
    assert tconfig.to_dict(tconfig.from_dict(Outer, overrides)) == jconfig.to_dict(jconfig.from_dict(Outer, overrides))


def test_cli_parse_matches_jax(tmp_path):
    path = tmp_path / "cli.yaml"
    path.write_text("steps: 4\ncap: 9\ninner:\n  rate: 0.75\n")
    argv = ["--config", str(path), "--weights", "0.1,0.2", "--flag", "true", "--steps", "5"]
    got, want = tconfig.cli_parse(Outer, argv), jconfig.cli_parse(Outer, argv)
    assert tconfig.to_dict(got) == jconfig.to_dict(want)
    assert got.steps == 5 and got.cap == 9 and got.inner.rate == 0.75 and got.weights == [0.1, 0.2]


def test_train_cli_reads_its_config_file(tmp_path):
    """`train_debias --config FILE` sets the CLI's own fields, the flags
    after it win, and `--debias_config` reaches the preset."""
    cli = tmp_path / "cli.yaml"
    cli.write_text("tiny_smoke: true\nmax_train_steps: 3\ncheckpoint_tmp_every: 5\n")
    run = tmp_path / "run.yaml"
    run.write_text("train_unet: true\nval_images_per_prompt: 6\n")
    cfg = train_debias.parse_args(["--config", str(cli), "--max_train_steps", "4", "--debias_config", str(run)])
    assert (cfg.tiny_smoke, cfg.max_train_steps, cfg.checkpoint_tmp_every) == (True, 4, 5)
    dcfg = train_debias.debias_config(cfg)
    # the tiny run's sizes are applied after the file, as in the JAX CLI
    assert dcfg.train_unet and dcfg.max_train_steps == 4 and dcfg.val_images_per_prompt == 2
