"""LBIM fused step — decode (memory-bound) + prefill chunk (compute-bound)
(port of ``repro.core.interleave``).

The JAX package put both halves in one XLA program so the scheduler could
hide the cache stream under the prefill GEMMs. In this slice the two halves
run back to back on PyTorch's current stream; overlapping them on two CUDA
streams is ROADMAP work. Pages are written in place and the two halves write
disjoint pages, so the order does not change a token.

Prefill chunks run in sub-chunks of ``sub_chunk`` tokens (the engine passes
its admission chunk). The admission quantum differs between modes, and a GEMM
of a different row count may round differently on the card; cutting every
chunk at the same token boundaries makes each token's arithmetic independent
of the quantum, so greedy tokens stay identical across BLOCKED/HBCEM/LBIM.
A token-coupled config (``ModelConfig.token_coupled``: the MoE capacity
dispatch, where which picks drop depends on the tokens of the call) is never
cut: a chunk is one forward over all its tokens, as the JAX package runs it,
and its tokens may then differ between modes, as the JAX engine's do.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def fused_step(params: dict, dec_cache: dict, dec_tokens: torch.Tensor, pre_cache: dict,
               pre_tokens: torch.Tensor, cfg: ModelConfig, *,
               sub_chunk: Optional[int] = None):
    """Returns (dec_logits, dec_cache', pre_logits, pre_cache')."""
    dec_logits, dec_cache = M.decode_step(params, dec_cache, dec_tokens, cfg)
    pre_logits, pre_cache = prefill_chunk_step(params, pre_cache, pre_tokens, cfg,
                                               sub_chunk=sub_chunk)
    return dec_logits, dec_cache, pre_logits, pre_cache


def decode_only_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig):
    return M.decode_step(params, cache, tokens, cfg)


def prefill_chunk_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig,
                       *, sub_chunk: Optional[int] = None, gemm: bool = False):
    """Chunked prefill = multi-token decode step(s) extending the cache.
    Returns the logits of the last sub-chunk and the cache after all of them.

    A chunk of more than one token takes the GEMM form in every sub-chunk,
    a one-token sub-chunk included, as the JAX package computes the whole
    chunk as one multi-token step; a one-token chunk is a decode step. A
    token-coupled config takes the whole chunk in one step."""
    t = tokens.shape[1]
    step = t if not sub_chunk or cfg.token_coupled else int(sub_chunk)
    gemm = gemm or t > 1
    logits = None
    for lo in range(0, t, step):
        logits, cache = M.decode_step(params, cache, tokens[:, lo:lo + step], cfg,
                                      gemm=gemm)
    return logits, cache
