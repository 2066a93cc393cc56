"""fairdiff_torch: the PyTorch/CUDA port of fairdiff for NVIDIA Hopper.

Mirrors the layout of the JAX package `fairdiff` module by module and is
held against it by the tests; it imports nothing from it. Entry points run
on CUDA unless the caller passes `device="cpu"`; without a CUDA device they
raise (see `device.resolve_device`).
"""

from fairdiff_torch.device import resolve_device

__all__ = ["resolve_device"]
