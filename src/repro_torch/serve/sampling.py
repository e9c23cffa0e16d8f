"""Token sampling, greedy part (port of ``repro.serve.sampling``).

Sampled decoding draws from JAX threefry keys (``request_key``/``token_key``
and ``jax.random.categorical``); reproducing it bit for bit needs a threefry
and ``fold_in`` port, which waits for a later slice. Until then the engine
refuses a request with ``temperature > 0`` rather than sampling from another
generator.
"""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits (B, T, V) → (B,) int32 argmax of the last position (first
    maximal index on ties, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)


def greedy_masked(logits: torch.Tensor, done: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """All-greedy masked sampling: retired/free lanes (``done``) emit ``pad_id``,
    active lanes the exact argmax."""
    tok = greedy(logits)
    return torch.where(done.to(tok.device), torch.full_like(tok, pad_id), tok)
