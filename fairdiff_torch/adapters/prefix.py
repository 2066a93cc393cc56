"""Soft prompt prefix, the exp-2 adapter (counterpart of
fairdiff/adapters/prefix.py): a trainable table [P, d] whose rows stand in
for synthetic token ids vocab_size .. vocab_size + P - 1.

The pooled output of prefixed ids points at a prefix slot, the knowingly
wrong output the JAX package and the reference keep; SD reads only the last
hidden state."""

from __future__ import annotations

import torch


def init_prefix(
    token_embedding: torch.Tensor,  # frozen table [V, d]
    num_tokens: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """Trainable prefix table [P, d]: copies of P rows of the frozen table
    at indices drawn from `generator` (a CPU generator)."""
    idx = torch.randint(0, token_embedding.shape[0], (num_tokens,), generator=generator)
    return token_embedding.detach()[idx.to(token_embedding.device)].clone()


def prepend_prefix_ids(
    input_ids: torch.Tensor,  # [B, S] with BOS at position 0
    num_tokens: int,
    vocab_size: int,
    max_length: int = 77,
) -> torch.Tensor:
    """Insert P synthetic ids after BOS, truncating to max_length."""
    B = input_ids.shape[0]
    prefix = torch.arange(
        vocab_size, vocab_size + num_tokens, dtype=input_ids.dtype, device=input_ids.device
    )
    out = torch.cat([input_ids[:, :1], prefix[None].expand(B, -1), input_ids[:, 1:]], dim=1)
    return out[:, :max_length]


def splice_prefix_embeds(
    token_embedding: torch.Tensor,  # [V, d] frozen table
    prefix_table: torch.Tensor,  # [P, d]
    input_ids: torch.Tensor,  # [B, S], ids >= V select prefix rows
) -> torch.Tensor:
    """Embedding lookup where ids >= V index the prefix table."""
    V = token_embedding.shape[0]
    is_prefix = input_ids >= V
    base = token_embedding[torch.where(is_prefix, 0, input_ids)]
    pref = prefix_table.to(token_embedding.dtype)[torch.where(is_prefix, input_ids - V, 0)]
    return torch.where(is_prefix[..., None], pref, base)
