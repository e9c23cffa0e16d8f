"""KV-cache data mapping — the paper's §III-C (port of ``repro.core.kv_mapping``).

Contiguous lanes keep K column-wise ``(B, H, hd, Lmax)`` and V row-wise
``(B, H, Lmax, hd)``, layer-stacked in front. K pages are column-wise
``(hd, Bsz)``, V pages row-wise ``(Bsz, hd)``; pools stack layers first: K
``(nL, P, H, hd, Bsz)``, V ``(nL, P, H, Bsz, hd)``. Where the JAX package
updated caches functionally (``.at[].set``, ``dynamic_update_slice``), the port
writes IN PLACE: a decode step must not copy a multi-gigabyte cache per layer.
Every in-place write is marked as such below.

The fixed-mapping baselines the paper compares against (``row_row``: K and V
both ``(.., Lmax, hd)``; ``col_col``: both ``(.., hd, Lmax)``) are kept for the
ablation: :func:`init_cache`, :func:`cache_specs`, :func:`append_layer`,
:func:`read_scores` and :func:`read_output` take every layout.
"""
from __future__ import annotations

from typing import Literal

import torch

Layout = Literal["cdpim", "row_row", "col_col"]


def _kv_shapes(n_layers, batch, n_kv_heads, head_dim, max_len, layout: Layout):
    lanes, rows, cols = ((n_layers, batch, n_kv_heads), (max_len, head_dim),
                         (head_dim, max_len))
    if layout not in ("cdpim", "row_row", "col_col"):
        raise ValueError(f"unknown layout {layout!r}; expected cdpim, row_row or col_col")
    k = rows if layout == "row_row" else cols
    v = cols if layout == "col_col" else rows
    return (*lanes, *k), (*lanes, *v)


def init_cache(n_layers: int, batch: int, n_kv_heads: int, head_dim: int, max_len: int,
               dtype=torch.bfloat16, device=None, layout: Layout = "cdpim") -> dict:
    """An empty layer-stacked cache, fill level ``pos`` 0: cdpim K (nL, B, H,
    hd, Lmax) column-wise and V (nL, B, H, Lmax, hd) row-wise; ``row_row``
    both (.., Lmax, hd); ``col_col`` both (.., hd, Lmax)."""
    k_shape, v_shape = _kv_shapes(n_layers, batch, n_kv_heads, head_dim, max_len, layout)
    return {
        "k": torch.zeros(k_shape, dtype=dtype, device=device),
        "v": torch.zeros(v_shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "layout": layout,
    }


def cache_specs(n_layers: int, batch: int, n_kv_heads: int, head_dim: int, max_len: int,
                dtype=torch.bfloat16, layout: Layout = "cdpim") -> dict:
    """:func:`init_cache` on the ``meta`` device: shapes and dtypes, no storage."""
    return init_cache(n_layers, batch, n_kv_heads, head_dim, max_len, dtype, "meta", layout)


def append_layer(k_cache: torch.Tensor, v_cache: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, pos, layout: Layout = "cdpim") -> None:
    """Write T new tokens' K/V at fill ``pos`` of one layer's lanes IN PLACE.

    ``k_new``/``v_new`` (B, H, T, hd); ``pos`` a scalar or (B,) per-lane fill.
    A column-wise cache (B, H, hd, Lmax) takes columns ``pos .. pos+T-1`` (a
    column write per token), a row-wise one (B, H, Lmax, hd) rows: cdpim
    writes K columns and V rows, ``row_row`` rows of both, ``col_col`` columns
    of both. As in the JAX package's ``dynamic_update_slice``, a window
    running past Lmax is moved back to end at Lmax.
    """
    b, _, t, _ = k_new.shape
    k_cols = layout in ("cdpim", "col_col")
    lmax = k_cache.shape[-1] if k_cols else k_cache.shape[-2]
    pos = torch.as_tensor(pos, device=k_cache.device).long().reshape(-1).expand(b)
    start = pos.clamp(0, lmax - t)                                        # (B,)
    idx = start[:, None] + torch.arange(t, device=k_cache.device)         # (B, T)
    lanes = torch.arange(b, device=k_cache.device)[:, None]
    # separated advanced indices put the (B, T) index dims in front
    for cache, new, cols in ((k_cache, k_new, k_cols), (v_cache, v_new, layout == "col_col")):
        if cols:
            cache[lanes, :, :, idx] = new.to(cache.dtype).transpose(1, 2)   # in place
        else:
            cache[lanes, :, idx, :] = new.to(cache.dtype).transpose(1, 2)   # in place


def init_paged_cache(n_layers: int, n_pages: int, n_kv_heads: int, head_dim: int,
                     block: int, dtype=torch.bfloat16, device=None) -> dict:
    """Allocate an empty physical page pool (cdpim per-block layout)."""
    return {
        "k_pages": torch.zeros((n_layers, n_pages, n_kv_heads, head_dim, block),
                               dtype=dtype, device=device),
        "v_pages": torch.zeros((n_layers, n_pages, n_kv_heads, block, head_dim),
                               dtype=dtype, device=device),
    }


def extract_block(k_lane: torch.Tensor, v_lane: torch.Tensor, block_idx: int,
                  block: int):
    """Cut logical block ``block_idx`` out of one contiguous lane: K lane
    (nL, H, hd, Lmax) -> K page (nL, H, hd, Bsz); V lane (nL, H, Lmax, hd) ->
    V page (nL, H, Bsz, hd). Slicing only (views)."""
    lo = block_idx * block
    return k_lane[..., lo:lo + block], v_lane[..., lo:lo + block, :]


def append_layer_paged(k_pages: torch.Tensor, v_pages: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor, pos: torch.Tensor,
                       table: torch.Tensor, block: int) -> None:
    """Write T new tokens' K/V into their pages IN PLACE.

    ``k_pages`` (P, H, hd, Bsz) / ``v_pages`` (P, H, Bsz, hd) are one layer's
    pages; ``k_new``/``v_new`` (B, H, T, hd); ``pos`` (B,) fill levels;
    ``table`` (B, NB) physical page ids. Token ``pos + t`` of lane ``b`` lands
    at offset ``(pos+t) % block`` of page ``table[b, (pos+t) // block]``: a K
    column write and a V row write inside the page. The pool guarantees
    residency before the step; free lanes all alias one dummy page.

    Free lanes' one-token writes collide there, and on the card the winner of
    colliding writes is unspecified. So every lane of a collision writes the
    last such lane's K/V (what the JAX package's scatter and PyTorch's give on
    the CPU), and the dummy page's content, which the free lanes then read,
    does not depend on the device. A token-coupled config needs that, since a
    free lane's MoE picks take live lanes' capacity; for the others a free
    lane's output is thrown away.
    """
    b, _, t, _ = k_new.shape
    k_new = k_new.to(k_pages.dtype)
    v_new = v_new.to(v_pages.dtype)
    pos = pos.long()
    table = table.long()
    if t == 1:
        page = table[torch.arange(b, device=table.device), pos // block]   # (B,)
        off = pos % block                                                  # (B,)
        flat = page * block + off
        lane = torch.arange(b, device=flat.device)
        src = torch.where(flat[:, None] == flat[None, :], lane[None, :], -1).amax(1)
        k_pages[page, :, :, off] = k_new[src, :, 0, :]     # in place
        v_pages[page, :, off, :] = v_new[src, :, 0, :]     # in place
        return
    t_idx = pos[:, None] + torch.arange(t, device=pos.device)              # (B, T)
    page = torch.gather(table, 1, t_idx // block)
    off = t_idx % block
    # separated advanced indices put the (B, T) index dims in front
    k_pages[page, :, :, off] = k_new.transpose(1, 2)     # in place, (B, T, H, hd)
    v_pages[page, :, off, :] = v_new.transpose(1, 2)     # in place


def materialize_lanes(k_pages: torch.Tensor, v_pages: torch.Tensor,
                      table: torch.Tensor):
    """Gather every lane's pages into contiguous dual-layout caches:
    K (B, H, hd, NB*Bsz), V (B, H, NB*Bsz, hd). Garbage beyond each lane's
    fill level is masked by the caller."""
    idx = table.long()
    kg = k_pages[idx]                                   # (B, NB, H, hd, Bsz)
    vg = v_pages[idx]                                   # (B, NB, H, Bsz, hd)
    b, nb, h, hd, bsz = kg.shape
    k = kg.permute(0, 2, 3, 1, 4).reshape(b, h, hd, nb * bsz)
    v = vg.permute(0, 2, 1, 3, 4).reshape(b, h, nb * bsz, hd)
    return k, v


def gather_pages(k_pages: torch.Tensor, v_pages: torch.Tensor, table):
    """Materialize a contiguous prefix from layer-stacked pages: ``table``
    (n,) physical page ids in logical order -> K (nL, H, hd, n*Bsz),
    V (nL, H, n*Bsz, hd). Gather + permute only."""
    idx = torch.as_tensor(table, dtype=torch.long, device=k_pages.device)
    kg = k_pages[:, idx]                                # (nL, n, H, hd, Bsz)
    vg = v_pages[:, idx]                                # (nL, n, H, Bsz, hd)
    nl, n, h, hd, bsz = kg.shape
    k = kg.permute(0, 2, 3, 1, 4).reshape(nl, h, hd, n * bsz)
    v = vg.permute(0, 2, 1, 3, 4).reshape(nl, h, n * bsz, hd)
    return k, v


def store_block(pages: dict, phys: int, k_block: torch.Tensor,
                v_block: torch.Tensor) -> dict:
    """Write one (K page, V page) pair into physical slot ``phys`` IN PLACE;
    returns ``pages`` (the same tensors)."""
    pages["k_pages"][:, phys].copy_(k_block)    # in place
    pages["v_pages"][:, phys].copy_(v_block)    # in place
    return pages


def read_scores(q: torch.Tensor, k_cache: torch.Tensor,
                layout: Layout = "cdpim") -> torch.Tensor:
    """Score GEMV: q (B,Hkv,G,T,hd) × K-cache -> (B,Hkv,G,T,Lmax). The cdpim
    and ``col_col`` layouts contract the minor ``hd`` axis against K columns;
    ``row_row`` contracts against (Lmax, hd) rows."""
    k = k_cache.to(q.dtype)[:, :, None]
    return torch.matmul(q, k if layout in ("cdpim", "col_col") else k.transpose(-1, -2))


def read_output(p: torch.Tensor, v_cache: torch.Tensor,
                layout: Layout = "cdpim") -> torch.Tensor:
    """Output GEMV: probs (B,Hkv,G,T,Lmax) × V-cache -> (B,Hkv,G,T,hd). The cdpim
    and ``row_row`` layouts contract the major ``L`` axis against V rows;
    ``col_col`` against (hd, Lmax) columns."""
    v = v_cache.to(p.dtype)[:, :, None]
    return torch.matmul(p, v if layout in ("cdpim", "row_row") else v.transpose(-1, -2))
