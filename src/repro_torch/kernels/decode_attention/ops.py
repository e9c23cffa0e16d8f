"""Public ops for decode attention: GQA reshape, and split clamping for pages
(port of ``repro.kernels.decode_attention.ops``). The JAX package padded a
contiguous cache's length to its L tile; the CUDA kernel bounds every lane's
walk by its live range itself, so there is no padding pass here.

Each kernel call reports its work to an active cost counter
(``kernels.work.kernel_scope``) at the cache's capacity, every slot live: the
count then needs no data (``meta`` tensors have none), as a compiler's cost
analysis counts static shapes. ``meta`` tensors get outputs of the right shape
and dtype and compute nothing."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import ref
from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention, decode_attention_paged, merge_splits, split_partials)
from repro_torch.kernels.work import attn_work, kernel_scope, merge_work


def _meta_out(*shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device="meta")


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
    """Returns (B, Hq, hd) float32; an empty range gives zeros. K and V may
    be a window of the lanes' KV heads (``cache[:, j0:j1]``, the partitioned
    program's), read in place; the work reported is the window's."""
    b, hq, hd = q.shape
    hkv = k_cache.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, hd)
    with kernel_scope("decode_attention", lambda: attn_work(
            b * k_cache.shape[-1], b, hkv, g, hd, b * hq * hd * 4,
            kv_bytes=k_cache.element_size(), q_bytes=q.element_size())):
        if q.device.type == "meta":
            return _meta_out(b, hq, hd)
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
    g = hq // hkv
    qg = q.reshape(b, hkv, g, hd)
    nb = block_table.shape[1]
    splits = max(1, min(int(num_splits), nb))
    meta = q.device.type == "meta"

    def work(out_bytes):     # every slot of every lane's table live
        return lambda: attn_work(b * nb * k_pages.shape[-1], b, hkv, g, hd, out_bytes,
                                 kv_bytes=k_pages.element_size(), q_bytes=q.element_size())

    if splits == 1:
        with kernel_scope("decode_attention_paged", work(b * hq * hd * 4)):
            if meta:
                return _meta_out(b, hq, hd)
            out = decode_attention_paged(qg, k_pages, v_pages, block_table, pos, start,
                                         scale=scale, softcap=softcap)
        return out.reshape(b, hq, hd)
    _, n_real = ref.realized_splits(nb, splits)
    with kernel_scope("decode_attention_paged_split", work(b * hkv * n_real * g * (hd + 2) * 4)):
        parts = ((_meta_out(b, hkv, n_real, g, hd), _meta_out(b, hkv, n_real, g),
                  _meta_out(b, hkv, n_real, g)) if meta else
                 split_partials(qg, k_pages, v_pages, block_table, pos, start,
                                num_splits=splits, scale=scale, softcap=softcap))
    with kernel_scope("merge_splits", lambda: merge_work(b, hkv, n_real, g, hd)):
        out = _meta_out(b, hkv, g, hd) if meta else merge_splits(*parts)
    return out.reshape(b, hq, hd)
