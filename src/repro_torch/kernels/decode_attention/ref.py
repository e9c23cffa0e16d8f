"""Plain PyTorch versions of the paged decode-attention kernels (CD-PIM KV mapping).

The port of ``repro.kernels.decode_attention.ref``: the CPU path of the
wrappers, and what ``chip_smoke.py`` holds the CUDA kernels against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.3819763e38


def _per_lane(v, b: int, device, default: int) -> torch.Tensor:
    """Scalar / (B,) / None -> (B,) int32 on ``device``."""
    if v is None:
        return torch.full((b,), default, dtype=torch.int32, device=device)
    return torch.as_tensor(v, dtype=torch.int32, device=device).reshape(-1).expand(b)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         pos, scale: float, softcap: Optional[float] = None,
                         start=None) -> torch.Tensor:
    """q (B, Hkv, G, hd); K (B, Hkv, hd, Lmax) column-wise; V (B, Hkv, Lmax, hd)
    row-wise; each lane attends to ``[start, pos)``. Returns (B, Hkv, G, hd)
    float32; an empty range yields zeros."""
    b = q.shape[0]
    lmax = k_cache.shape[-1]
    pos_b = _per_lane(pos, b, q.device, 0)
    start_b = _per_lane(start, b, q.device, 0)
    # outer-product flow: contract hd against K columns
    s = torch.matmul(q.float(), k_cache.float()) * scale          # (B, Hkv, G, L)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    idx = torch.arange(lmax, device=q.device)
    valid = (idx[None, :] >= start_b[:, None]) & (idx[None, :] < pos_b[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    p = torch.where(valid[:, None, None, :], p, torch.zeros_like(p))
    # inner-product flow: contract L against V rows
    return torch.matmul(p, v_cache.float())


def materialize_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                      block_table: torch.Tensor):
    """Gather paged KV back to per-lane contiguous dual-layout caches:
    K (B, H, hd, NB*Bsz), V (B, H, NB*Bsz, hd). Gather + permute only."""
    bt = block_table.long()
    kg = k_pages[bt]                                   # (B, NB, H, hd, Bsz)
    vg = v_pages[bt]                                   # (B, NB, H, Bsz, hd)
    b, nb, h, hd, bsz = kg.shape
    k = kg.permute(0, 2, 3, 1, 4).reshape(b, h, hd, nb * bsz)
    v = vg.permute(0, 2, 1, 3, 4).reshape(b, h, nb * bsz, hd)
    return k, v


def decode_attention_paged_ref(q, k_pages, v_pages, block_table, pos, scale: float,
                               softcap: Optional[float] = None, start=None) -> torch.Tensor:
    """Gather-materialize version of the paged kernel (B1)."""
    k, v = materialize_pages(k_pages, v_pages, block_table)
    return decode_attention_ref(q, k, v, pos, scale, softcap, start=start)


def merge_splits(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Stage-2 reduction of per-split flash-softmax partials.

    ``acc`` (B, Hkv, S, G, hd), ``m``/``l`` (B, Hkv, S, G). A dead split
    carries ``m = NEG_INF, l = 0, acc = 0`` and contributes nothing; an
    all-dead lane yields zeros because exp(NEG_INF - NEG_INF) = 1 meets l = 0
    (a ``-inf`` sentinel would give NaN here).
    """
    m_max = m.amax(dim=2)                                         # (B, Hkv, G)
    alpha = torch.exp(m - m_max[:, :, None])                      # (B, Hkv, S, G)
    l_tot = (l * alpha).sum(dim=2)                                # (B, Hkv, G)
    out = (acc * alpha[..., None]).sum(dim=2)                     # (B, Hkv, G, hd)
    return out / torch.where(l_tot > 0.0, l_tot, torch.ones_like(l_tot))[..., None]


def realized_splits(nb: int, num_splits: int) -> tuple[int, int]:
    """(blocks per split, realized splits): ``bps = ceil(NB/S)``,
    ``S_real = ceil(NB/bps)`` — the JAX kernel's rule (decode_attention.py:336)."""
    bps = -(-nb // max(int(num_splits), 1))
    return bps, -(-nb // bps)


def split_partials_ref(q, k_pages, v_pages, block_table, pos, num_splits: int,
                       scale: float, softcap: Optional[float] = None, start=None):
    """Stage 1 of the split-KV reduction: per-split unnormalized ``(acc, m, l)``
    over each realized split's block range; a dead split gives the identity
    partial. Returns acc (B, Hkv, S, G, hd), m and l (B, Hkv, S, G)."""
    b = q.shape[0]
    nb = block_table.shape[1]
    bsz = k_pages.shape[-1]
    k, v = materialize_pages(k_pages, v_pages, block_table)
    lmax = nb * bsz
    pos_b = _per_lane(pos, b, q.device, 0)
    start_b = _per_lane(start, b, q.device, 0)
    s_all = torch.matmul(q.float(), k.float()) * scale
    if softcap is not None:
        s_all = softcap * torch.tanh(s_all / softcap)
    idx = torch.arange(lmax, device=q.device)
    valid = (idx[None, :] >= start_b[:, None]) & (idx[None, :] < pos_b[:, None])
    s_all = torch.where(valid[:, None, None, :], s_all, torch.full_like(s_all, NEG_INF))
    bps, n_splits = realized_splits(nb, num_splits)
    vf = v.float()
    accs, ms, ls = [], [], []
    for si in range(n_splits):
        lo, hi = si * bps * bsz, min((si + 1) * bps, nb) * bsz
        s = s_all[..., lo:hi]
        live = valid[:, lo:hi].any(dim=-1)                        # (B,)
        m = s.amax(dim=-1)                                        # (B, Hkv, G)
        m = torch.where(live[:, None, None], m, torch.full_like(m, NEG_INF))
        p = torch.exp(s - m[..., None])
        p = torch.where(live[:, None, None, None] & valid[:, None, None, lo:hi],
                        p, torch.zeros_like(p))
        ls.append(p.sum(dim=-1))
        accs.append(torch.matmul(p, vf[:, :, lo:hi, :]))
        ms.append(m)
    return torch.stack(accs, dim=2), torch.stack(ms, dim=2), torch.stack(ls, dim=2)


def decode_attention_paged_split_ref(q, k_pages, v_pages, block_table, pos,
                                     num_splits: int, scale: float,
                                     softcap: Optional[float] = None,
                                     start=None) -> torch.Tensor:
    """Split-KV version (B2): per-split partials merged by :func:`merge_splits`."""
    acc, m, l = split_partials_ref(q, k_pages, v_pages, block_table, pos, num_splits,
                                   scale, softcap, start=start)
    return merge_splits(acc, m, l)
