"""The port's run-level YAMLs (`fairdiff_torch/configs/*.yaml`) against the
JAX package's (`fairdiff/configs/*.yaml`): each parses through the port's
CLI parser, and every key but the JAX platform switch (`platform`,
`num_cpu_devices`, which the port's `device` replaces) carries the JAX
file's value."""

from pathlib import Path

import pytest
import yaml

from fairdiff_torch.tools import gen_images, train_debias
from fairdiff_torch.training.debias import DebiasConfig
from fairdiff_torch.utils import config as cfglib

ROOT = Path(__file__).resolve().parents[1]
NAMES = ["exp1", "exp2", "exp3", "exp4", "exp5", "exp6", "debias-unet-lora", "exp1_tiny_cpu", "gen_tiny_cpu"]
JAX_ONLY = {"platform", "num_cpu_devices"}


def _load(path: Path) -> dict:
    return yaml.safe_load(path.read_text()) or {}


def test_every_jax_run_config_has_a_port_counterpart():
    jax_names = sorted(p.stem for p in (ROOT / "fairdiff" / "configs").glob("*.yaml"))
    assert jax_names == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_port_config_parses_and_carries_the_jax_values(name):
    port_path = ROOT / "fairdiff_torch" / "configs" / f"{name}.yaml"
    jax = _load(ROOT / "fairdiff" / "configs" / f"{name}.yaml")
    port = _load(port_path)
    assert {k: v for k, v in port.items() if k != "device"} == {k: v for k, v in jax.items() if k not in JAX_ONLY}
    assert ("device" in port) == bool(JAX_ONLY & set(jax))
    if "device" in port:
        assert port["device"] == jax.get("platform", "cpu") == "cpu"
    if name == "debias-unet-lora":  # a DebiasConfig override (--debias_config)
        cfg = cfglib.load_yaml(DebiasConfig(), port_path)
    elif name.startswith("gen"):
        cfg = gen_images.parse_args(["--config", str(port_path)])
    else:
        cfg = train_debias.parse_args(["--config", str(port_path)])
    for key, value in port.items():
        got = getattr(cfg, key)
        want = tuple(type(got[0])(v) for v in str(value).split(",")) if isinstance(got, (tuple, list)) else value
        assert (tuple(got) if isinstance(got, list) else got) == want, key
