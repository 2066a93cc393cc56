"""Tokenizer access (counterpart of fairdiff/io/tokenizer.py).

A local CLIP tokenizer directory loads through `transformers`, imported
only when a directory is given; without one, a deterministic hash tokenizer
with the same call contract (bos/eos/pad semantics of CLIP) stands in.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from fairdiff_torch.utils.rng import stable_hash


@dataclasses.dataclass
class Tokenized:
    input_ids: np.ndarray  # [B, S] int32
    attention_mask: np.ndarray  # [B, S] int32


class HashTokenizer:
    """Deterministic stand-in tokenizer (bos/eos/pad semantics match CLIP)."""

    def __init__(self, vocab_size: int = 49408, model_max_length: int = 77):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length
        self.bos_token_id = vocab_size - 2
        self.eos_token_id = vocab_size - 1
        self.pad_token_id = vocab_size - 1  # CLIP pads with eos

    def __call__(
        self, texts: list[str], padding: str = "longest", max_length: int | None = None
    ) -> Tokenized:
        max_length = max_length or self.model_max_length
        seqs = []
        for t in texts:
            words = t.lower().split()[: max_length - 2]
            ids = [self.bos_token_id]
            ids += [stable_hash(w) % (self.vocab_size - 2) for w in words]
            ids.append(self.eos_token_id)
            seqs.append(ids)
        width = max_length if padding == "max_length" else max(len(s) for s in seqs)
        ids = np.full((len(seqs), width), self.pad_token_id, np.int32)
        mask = np.zeros((len(seqs), width), np.int32)
        for i, s in enumerate(seqs):
            ids[i, : len(s)] = s[:width]
            mask[i, : len(s)] = 1
        return Tokenized(ids, mask)


def load_tokenizer(path: str | Path | None):
    """CLIPTokenizer from a local directory when one is given, else
    HashTokenizer."""
    if path is None:
        return HashTokenizer()
    if not Path(path).exists():
        raise FileNotFoundError(f"tokenizer directory {path} does not exist")
    from transformers import CLIPTokenizer

    tok = CLIPTokenizer.from_pretrained(str(path))

    class _Wrap:
        vocab_size = tok.vocab_size
        model_max_length = tok.model_max_length
        eos_token_id = tok.eos_token_id
        bos_token_id = tok.bos_token_id

        def __call__(self, texts, padding="longest", max_length=None):
            out = tok(
                texts,
                padding="max_length" if padding == "max_length" else True,
                max_length=max_length or tok.model_max_length,
                truncation=True,
                return_tensors="np",
            )
            return Tokenized(
                out["input_ids"].astype(np.int32),
                out["attention_mask"].astype(np.int32),
            )

    return _Wrap()
