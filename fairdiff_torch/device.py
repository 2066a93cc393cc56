"""Device resolution for the port's entry points.

CUDA is the default. The CPU runs only when it is asked for by name (the
tests do); a caller that asked for nothing on a machine without CUDA gets
an error, never a silent CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None or "" -> "cuda"; "cpu" -> the CPU; raises when CUDA is asked
    for (or implied) and absent."""
    dev = torch.device(device or "cuda")
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
