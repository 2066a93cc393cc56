"""The general traffic generator: a traffic mix's parameters (a JSON file
under traffic/) and the run's seed -> the work, the same for the same seed.

Prompts are the occupation template with an occupation drawn from the
mix's list, tokenized as CLIP pads them: BOS, one id a word (a stable hash
of the word into the vocabulary, below the special ids), EOS, then EOS to
77. The unconditional prompt is BOS, EOS, padded. Every seed gets the same
sizes in another order:

- "train": step 0 (set-up, the step the reference follows) takes a count
  drawn from [low, high]; the window's steps take theirs in triples that
  sum to 3 x the middle ((19, 21, 23), (20, 21, 22), (21, 21, 21) for
  exp-1's 19-23), the triples and the order inside each drawn from the
  seed, so a window of 3, 6, ... steps does the same work on every seed
  (an exp-1 step on one H100 takes about 18 s: three to a 51-s window).
  Lane noises are drawn on the device from the seed and the step.
- "gen": prompts in a seeded order, each with `images_per_prompt` images
  in batches of `batch`, the image indices of the noise bank.
"""

from __future__ import annotations

import hashlib
from typing import Iterator

import numpy as np
import torch

VOCAB, LENGTH = 49408, 77  # CLIP's: BOS = VOCAB - 2, EOS = VOCAB - 1


def word_id(word: str, vocab: int = VOCAB) -> int:
    digest = hashlib.blake2b(word.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(digest, "little") % (vocab - 3) + 1


def prompt_ids(text: str, vocab: int = VOCAB, length: int = LENGTH) -> torch.Tensor:
    """[1, length] ids: BOS, a word id each, EOS, EOS padding."""
    bos, eos = vocab - 2, vocab - 1
    words = text.replace(",", " ,").split()
    ids = [bos] + [word_id(w, vocab) for w in words][: length - 2] + [eos]
    return torch.tensor([ids + [eos] * (length - len(ids))], dtype=torch.long)


def uncond_ids(vocab: int = VOCAB, length: int = LENGTH) -> torch.Tensor:
    return torch.tensor([[vocab - 2] + [vocab - 1] * (length - 1)], dtype=torch.long)


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng([seed & ((1 << 64) - 1), int.from_bytes(tag.encode()[:8].ljust(8, b"\0"), "little")])


def prompts(mix: dict, seed: int) -> list[str]:
    """The mix's prompts in the seed's order."""
    occ = list(mix["prompts"]["occupations"])
    order = rng(seed, "prompts").permutation(len(occ))
    return [mix["prompts"]["template"].format(occ[i]) for i in order]


def train_step_counts(mix: dict, seed: int, n: int) -> list[int]:
    """Denoising steps of steps 0..n-1 (step 0 the set-up step)."""
    low, high = mix["denoising_steps"]
    if (low + high) % 2:
        raise ValueError(f"denoising_steps {low}-{high} has no middle count")
    mid = (low + high) // 2
    r = rng(seed, "steps")
    counts = [int(r.integers(low, high + 1))]
    triples = [(a, mid, low + high - a) for a in range(low, mid + 1)]
    while len(counts) < n:
        for i in r.permutation(len(triples)):
            counts += [triples[i][j] for j in r.permutation(3)]
    return counts[:n]


def lane_noises(seed: int, step: int, shape: tuple[int, ...], device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + step) % (1 << 63))
    return torch.randn(shape, generator=g, device=device)


def train_steps(mix: dict, seed: int, latent: tuple[int, int, int], device, vocab: int = VOCAB,
                length: int = LENGTH, n: int = 64) -> Iterator[dict]:
    """Step k: {"step", "n_steps", "prompt", "cond_ids", "uncond_ids", "noises"}."""
    texts = prompts(mix, seed)
    for k, n_steps in enumerate(train_step_counts(mix, seed, n)):
        text = texts[k % len(texts)]
        yield {"step": k, "n_steps": n_steps, "prompt": text, "cond_ids": prompt_ids(text, vocab, length),
               "uncond_ids": uncond_ids(vocab, length), "noises": lane_noises(seed, k, (mix["lanes"], *latent), device)}


def gen_batches(mix: dict, seed: int, vocab: int = VOCAB, length: int = LENGTH) -> Iterator[dict]:
    """Batch k: {"batch", "prompt_index", "prompt", "cond_ids", "uncond_ids", "images"}."""
    k = 0
    while True:
        for pi, text in enumerate(prompts(mix, seed)):
            for start in range(0, mix["images_per_prompt"], mix["batch"]):
                idx = list(range(start, min(start + mix["batch"], mix["images_per_prompt"])))
                yield {"batch": k, "prompt_index": pi, "prompt": text, "cond_ids": prompt_ids(text, vocab, length),
                       "uncond_ids": uncond_ids(vocab, length), "images": idx}
                k += 1
