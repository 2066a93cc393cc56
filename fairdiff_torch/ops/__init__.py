"""The port's hand-written kernels as PyTorch ops: flash attention (K1, K2,
K3, K6), GEGLU (K4, K5) and group norm (K7).

Each op module counts its kernel launches in module globals (`launches`,
`launches_lse`, ...) where a wrapper launches. A launch made while the
current stream captures a CUDA graph runs only when the graph replays, so
the wrappers do not count it (`counting`): whoever replays the graph adds
one replay's launches (`add_launches`), as read from `launch_counts` around
an eager run of the captured body.
"""

from __future__ import annotations

import importlib

import torch

# launch_counts' names: (op module, its counter)
COUNTERS = {
    "flash_attention": ("flash_attention", "launches"),
    "flash_attention_short": ("flash_attention", "launches_short"),
    "flash_attention_lse": ("flash_attention", "launches_lse"),
    "flash_attention_dq": ("flash_attention", "launches_dq"),
    "flash_attention_dkv": ("flash_attention", "launches_dkv"),
    "flash_attention_bwd_merged": ("flash_attention", "launches_merged"),
    "geglu": ("geglu", "launches"),
    "geglu_dx": ("geglu", "launches_dx"),
    "group_norm": ("group_norm", "launches"),
}


def counting() -> bool:
    """Whether a launch on the current CUDA stream runs now: false while the
    stream captures a CUDA graph."""
    return not torch.cuda.is_current_stream_capturing()


def launch_counts() -> dict[str, int]:
    """The launch counters of every kernel wrapper, by `COUNTERS`' names."""
    return {name: getattr(importlib.import_module(f"{__name__}.{mod}"), attr)
            for name, (mod, attr) in COUNTERS.items()}


def add_launches(counts: dict[str, int]) -> None:
    """Add `counts` (by `COUNTERS`' names) to the wrappers' counters."""
    for name, n in counts.items():
        mod, attr = COUNTERS[name]
        module = importlib.import_module(f"{__name__}.{mod}")
        setattr(module, attr, getattr(module, attr) + n)
