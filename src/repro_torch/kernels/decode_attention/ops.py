"""Public ops for decode attention: GQA reshape, and split clamping for pages
(port of ``repro.kernels.decode_attention.ops``). The JAX package padded a
contiguous cache's length to its L tile; the CUDA kernel bounds every lane's
walk by its live range itself, so there is no padding pass here."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention, decode_attention_paged, decode_attention_paged_split)


def decode_attention_op(
    q: torch.Tensor,        # (B, Hq, hd) — ungrouped query heads
    k_cache: torch.Tensor,  # (B, Hkv, hd, Lmax) column-wise
    v_cache: torch.Tensor,  # (B, Hkv, Lmax, hd) row-wise
    pos,                    # scalar or (B,) int32 — end of the live range
    *,
    start=None,             # scalar or (B,) int32 — live-range start; None -> 0
    scale: float,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Returns (B, Hq, hd) float32; an empty range gives zeros."""
    b, hq, hd = q.shape
    hkv = k_cache.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, hd)
    out = decode_attention(qg, k_cache, v_cache, pos, start, scale=scale, softcap=softcap)
    return out.reshape(b, hq, hd)


def decode_attention_paged_op(
    q: torch.Tensor,            # (B, Hq, hd) — ungrouped query heads
    k_pages: torch.Tensor,      # (P, Hkv, hd, Bsz) column-wise pages
    v_pages: torch.Tensor,      # (P, Hkv, Bsz, hd) row-wise pages
    block_table: torch.Tensor,  # (B, NB) int32 — physical page per logical block
    pos,                        # scalar or (B,) int32 — end of the live range
    *,
    start=None,                 # scalar or (B,) int32 — live-range start; None -> 0
    scale: float,
    softcap: Optional[float] = None,
    num_splits: int = 1,
) -> torch.Tensor:
    """Returns (B, Hq, hd) float32. ``num_splits > 1`` routes through the
    two-stage split-KV reduction (allclose to, not bit-identical with, one
    pass); splits are clamped to the block count."""
    b, hq, hd = q.shape
    hkv = k_pages.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, hd)
    splits = max(1, min(int(num_splits), block_table.shape[1]))
    if splits > 1:
        out = decode_attention_paged_split(qg, k_pages, v_pages, block_table, pos, start,
                                           num_splits=splits, scale=scale, softcap=softcap)
    else:
        out = decode_attention_paged(qg, k_pages, v_pages, block_table, pos, start,
                                     scale=scale, softcap=softcap)
    return out.reshape(b, hq, hd)
