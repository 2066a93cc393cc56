"""Deterministic seeding (the port's counterpart of fairdiff/utils/rng.py).

`stable_hash` is a copy of the JAX package's blake2b string hash. The noise
bank and the trainer's per-step draws (step count, lane noises) come from
`torch.Generator`s seeded per (seed, prompt, index) or (seed, step), so they
are reproducible across processes and devices; their numbers differ from
the JAX package's `jax.random` draws at the same seed (the trainer also
takes its noises and step count explicitly, so tests can feed it JAX's).
"""

from __future__ import annotations

import hashlib

import torch


def stable_hash(text: str, bits: int = 31) -> int:
    """Deterministic cross-process string hash (Python's `hash` is salted
    per process)."""
    digest = hashlib.blake2b(text.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(digest, "little") % (1 << bits)


def prompt_noise_generator(seed: int, prompt: str, index: int) -> torch.Generator:
    """CPU generator for the per-(prompt, image-index) noise bank. Noise is
    drawn on the CPU and then moved, so the bank is the same on every
    device."""
    g = torch.Generator(device="cpu")
    g.manual_seed(stable_hash(f"{seed}/{stable_hash(prompt)}/{index}", bits=63))
    return g


def _generator(key: str) -> torch.Generator:
    g = torch.Generator(device="cpu")
    g.manual_seed(stable_hash(key, bits=63))
    return g


def sample_num_denoising_steps(seed: int, step: int, low: int = 19, high: int = 23) -> int:
    """Uniform draw from {low..high} per (seed, step) (the reference's rank-0
    draw, exp-1:1779-1781; `sample_num_denoising_steps` in the JAX package)."""
    return int(torch.randint(low, high + 1, (), generator=_generator(f"{seed}/steps/{step}")))


def train_noises(seed: int, step: int, shape: tuple[int, ...]) -> torch.Tensor:
    """The step's lane noises [N, h, w, 4], drawn on the CPU (`noise_key`)."""
    return torch.randn(shape, generator=_generator(f"{seed}/noise/{step}"))
