"""The converted-parameter store (counterpart of fairdiff/io/checkpoints.py).

`tools/convert_sd` and `tools/convert_guidance` write each converted model
as one `torch.save` of its module's state dict, `<dir>/<name>.pt` (for SD:
`text_encoder.pt`, `unet.pt`, `vae.pt`). The JAX package keeps orbax trees
under `<dir>/<name>/` instead; orbax imports JAX, so the port does not read
them, and a directory that holds only those raises with the command that
writes the port's store.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import torch

from fairdiff_torch.io.from_jax import state_dict_from_jax

SD_MODELS = ("text_encoder", "unet", "vae")


def store_path(directory: str | Path, name: str) -> Path:
    """`<dir>/<name>.pt`; raises when it is missing, naming the converter
    (and saying so when the JAX package's orbax tree is there instead)."""
    d = Path(directory)
    path = d / f"{name}.pt"
    if path.exists():
        return path
    tool = "fairdiff_torch.tools." + ("convert_sd" if name in SD_MODELS else "convert_guidance")
    if (d / name).is_dir():
        raise NotImplementedError(
            f"{d / name} is the JAX package's orbax tree, which the port does not read (orbax imports JAX); "
            f"convert the source checkpoint with `python -m {tool}` into the port's store")
    raise FileNotFoundError(f"{path} is missing: write it with `python -m {tool}`")


def save_params(directory: str | Path, params: Mapping[str, Any]) -> None:
    """Each `{name: parameter tree}` (the converters' layout) as the state
    dict of the port's matching module, `<dir>/<name>.pt`."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    for name, tree in params.items():
        tmp = d / f"{name}.pt.tmp"
        torch.save(state_dict_from_jax(tree), tmp)
        tmp.replace(d / f"{name}.pt")


def cast_floats(state: dict[str, torch.Tensor], dtype: torch.dtype | str) -> dict[str, torch.Tensor]:
    """Floating tensors cast to `dtype` (the frozen-weight policy); others
    (ids, counts) pass through."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}


def load_params(directory: str | Path, names: list[str], *, cast: Any = None) -> dict[str, dict[str, torch.Tensor]]:
    """{name: state dict} of the store, memory-mapped from the files (on
    the CPU; a cast copies)."""
    out = {}
    for name in names:
        state = torch.load(store_path(directory, name), map_location="cpu", weights_only=True, mmap=True)
        out[name] = cast_floats(state, cast) if cast is not None else state
    return out


def load_sd_params(directory: str | Path, *, cast: Any = "bfloat16") -> dict[str, dict[str, torch.Tensor]]:
    """-> {"text_encoder", "unet", "vae"} state dicts for StableDiffusion."""
    return load_params(directory, list(SD_MODELS), cast=cast)
