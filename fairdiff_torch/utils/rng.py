"""Deterministic seeding (the port's counterpart of fairdiff/utils/rng.py).

`stable_hash` is a copy of the JAX package's blake2b string hash. The noise
bank draws from a `torch.Generator` seeded per (seed, prompt, index), so it
is reproducible across processes and devices; its numbers differ from the
JAX CLI's `jax.random` bank at the same seed.
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

