"""Attention: GQA + RoPE over CD-PIM KV, contiguous lanes or block pages, and
the encoder-decoder's full-sequence and cross attention (port of
``repro.models.attention``).

Single-token decode steps go through ``core.dispatch`` (the CUDA flash-decode
kernels on the card, the plain versions on the CPU) with each lane's live
range ``[start, end)``, so sliding-window layers (``window``: ``start = end -
window``) and gemma2's W-slot ring lanes (:func:`attention_decode_ring`) run
the same kernels; with ``cfg.quantized_decode`` the decode-time qkv/o
projections run as W8A8 PIM GEMVs. Multi-token chunk-prefill steps gather the
lanes and run the dense masked einsum in plain PyTorch, as the JAX package
computes them outside any Pallas kernel. The full-sequence attention of
training and the full forward (:func:`attention_dense`: causal, gemma2's
local windows, the audio encoder's bidirectional form) and the decoder's
cross attention over the fixed encoder memory (:func:`attention_cross`,
:func:`project_memory_kv`) are plain PyTorch einsums too, on the float
weights: the JAX package has no kernel for them either.

**Partitioned** (``tp``: a ``dist.collectives.TensorParallel``, the model's
``mesh=`` form), a rank holds its columns of ``wq``/``wk``/``wv`` and its
rows of ``wo`` (Megatron tensor parallelism over ``model``): whole query
heads (:func:`kv_window`), while its K/V columns may split a head (yi-9b's
smoke config has one KV head of 16 columns; llama3-8b at model 16 holds 64
of a head's 128), so the new K/V are all-gathered over ``model`` before the
reshape to heads and RoPE, which pairs dims across the head. Every rank
writes the whole K/V into its lanes (the wide-batch cache spec replicates
them over ``model``) and attends with its query heads over its window of KV
heads, a view of the lanes (B4 reads it in place). The output projection
then gives the rank's partial sum, which the block reduces. The training
form (:func:`attention_dense` with ``tp``) attends the same way over the
whole sequence, without a cache; the gather's backward is a
reduce-scatter. The encoder-decoder's cross attention
(:func:`attention_cross`, :func:`project_memory_kv`) takes ``tp`` the same
way: the memory's K/V columns are gathered into every head, the rank's
query heads read their window of them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dispatch, kv_mapping
from repro_torch.core.quant import raw_weight
from repro_torch.device import torch_dtype
from repro_torch.dist.collectives import gather_from
from repro_torch.models.layers import apply_rope, dense_init, softcap

NEG_INF = -2.3819763e38  # bf16-safe large negative


def init_attention(generator: torch.Generator, cfg: ModelConfig, device) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    dtype = torch_dtype(cfg.param_dtype)
    p = {
        "wq": dense_init(generator, (d, cfg.n_heads * hd), dtype, device),
        "wk": dense_init(generator, (d, cfg.n_kv_heads * hd), dtype, device),
        "wv": dense_init(generator, (d, cfg.n_kv_heads * hd), dtype, device),
        "wo": dense_init(generator, (cfg.n_heads * hd, d), dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype, device=device)
    return p


def _dense_matmul(w, x: torch.Tensor) -> torch.Tensor:
    # GEMM-shaped ops on a prepared tree take the float operand
    return x @ raw_weight(w)


def _decode_linear(cfg: ModelConfig):
    """Decode-time matmul: W8A8 PIM GEMV at quantized GEMV shapes, else dense."""
    if cfg.quantized_decode:
        return lambda w, xx: dispatch.linear(w, xx, cfg)
    return _dense_matmul


def _own(bias: torch.Tensor, y: torch.Tensor, tp) -> torch.Tensor:
    """The entries of a (replicated) bias that match ``y``'s columns: all of
    it, or under ``tp`` the rank's share where ``y`` holds a share."""
    n = y.shape[-1]
    return bias if tp is None or bias.shape[0] == n else bias.narrow(0, tp.offset(n), n)


def _gather_kv(k: torch.Tensor, v: torch.Tensor, tp):
    """The rank's K and V columns (B, T, c) each -> every rank's, (B, T,
    size * c) each, through one all-gather over ``model`` (under autograd
    its backward is one reduce-scatter: each rank's K/V gradients are
    partial sums over the query heads it holds)."""
    kv = gather_from(torch.stack([k, v]), tp.mesh, "model", dim=-1)
    return kv[0], kv[1]


def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                 linear_fn=None, tp=None):
    """x (B,T,d) -> q (B,Hq,T,hd), k/v (B,Hkv,T,hd), RoPE applied. Under
    ``tp``, q holds the rank's query heads and K/V every head (gathered where
    the rank's columns are a share)."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    mm = linear_fn or _dense_matmul
    q = mm(p["wq"], x)
    k = mm(p["wk"], x)
    v = mm(p["wv"], x)
    if cfg.qkv_bias:
        q, k, v = q + _own(p["bq"], q, tp), k + _own(p["bk"], k, tp), v + _own(p["bv"], v, tp)
    if tp is not None and k.shape[-1] < cfg.n_kv_heads * hd:
        k, v = _gather_kv(k, v, tp)
    q = q.reshape(b, t, -1, hd).transpose(1, 2)
    k = k.reshape(b, t, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, t, cfg.n_kv_heads, hd).transpose(1, 2)
    q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
    k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def kv_window(cfg: ModelConfig, hq: int, tp) -> tuple[int, int]:
    """The KV heads ``[j0, j1)`` that a rank's ``hq`` query heads read (query
    head ``h`` reads KV head ``h // q_per_kv``): every KV head without
    ``tp`` or where the rank holds every query head; under ``tp`` its whole
    groups, or the one group its heads are part of (llama3-8b at model 16:
    2 of a KV head's 4)."""
    if tp is None or hq == cfg.n_heads:
        return 0, cfg.n_kv_heads
    h0, g = tp.offset(hq), cfg.q_per_kv
    if hq % g == 0:
        return h0 // g, (h0 + hq) // g
    if g % hq == 0:
        return h0 // g, h0 // g + 1
    raise ValueError(f"{hq} query heads a rank neither hold whole groups of {g} nor lie in "
                     f"one ({cfg.name}: {cfg.n_heads} heads, {cfg.n_kv_heads} KV heads)")


def _scale(cfg: ModelConfig) -> float:
    if cfg.attn_scale_override is not None:
        return cfg.attn_scale_override
    return cfg.head_dim ** -0.5


def _masked_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      positions: torch.Tensor, cfg: ModelConfig, dtype,
                      window: Optional[int] = None,
                      layout: kv_mapping.Layout = "cdpim") -> torch.Tensor:
    """Dense masked attention of T new tokens against contiguous lanes (the
    JAX package's multi-token decode form): q (B, Hq, T, hd), K and V in
    ``layout`` (cdpim: K (B, Hkv, hd, L), V (B, Hkv, L, hd)), query positions
    (B, T); a ``window`` also masks keys at or before ``q_pos - window``.
    Returns (B, T, Hq*hd)."""
    b, _, t, hd = q.shape
    lmax = k_cache.shape[-1] if layout in ("cdpim", "col_col") else k_cache.shape[-2]
    qg = q.reshape(b, k_cache.shape[1], -1, t, hd)
    s = kv_mapping.read_scores(qg, k_cache, layout).float() * _scale(cfg)
    s = softcap(s, cfg.attn_softcap)
    k_pos = torch.arange(lmax, device=q.device)
    valid = k_pos[None, None, :] <= positions[:, :, None]                 # (B, T, L)
    if window is not None:
        valid = valid & (k_pos[None, None, :] > positions[:, :, None] - window)
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    s = s + bias[:, None, None, :, :]
    pr = torch.softmax(s, dim=-1).to(dtype)
    y = kv_mapping.read_output(pr, v_cache, layout)
    return y.reshape(b, -1, t, hd).transpose(1, 2).reshape(b, t, -1)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int],
               causal: bool) -> torch.Tensor:
    """(Tq, Tk) additive f32 bias from the causal and sliding-window
    constraints: 0 where a query may read a key, ``NEG_INF`` elsewhere."""
    ok = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def attention_dense(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    window: Optional[int] = None, causal: bool = True,
                    positions: Optional[torch.Tensor] = None, return_kv: bool = False,
                    tp=None):
    """Full-sequence attention over x (B, T, d), the training and full
    forward's form (causal; gemma2's local layers pass their ``window``) and
    the audio encoder's (``causal=False``). Queries run ``cfg.q_chunk`` at a
    time (a T the chunk does not divide runs as one chunk) with f32 scores,
    the softcap, the mask bias and an f32 softmax cast back to x's dtype;
    under ``cfg.causal_block_skip`` a causal chunk i reads only the keys
    before ``(i + 1)·chunk``, which the mask would hide anyway. ``positions``
    (B, T) are the RoPE positions (default 0..T-1). Returns y (B, T, d), and
    with ``return_kv`` also (k, v), each (B, Hkv, T, hd) after RoPE. Float
    weights only (``raw_weight``).

    Under ``tp`` (the partitioned train step) ``x`` is the whole sequence, the
    rank projects its query heads and its K/V columns, gathers K/V over
    ``model`` before the reshape to heads and RoPE (:func:`_project_qkv`),
    attends with its heads against the KV heads they read (:func:`kv_window`;
    no cache) and returns its partial sum of the row-parallel ``wo``, which
    the block reduces."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    if positions is None:
        positions = torch.arange(t, device=x.device).expand(b, t)
    q, k, v = _project_qkv(p, x, cfg, positions, tp=tp)
    hq = q.shape[1]
    if tp is None:
        qg = q.reshape(b, cfg.n_kv_heads, cfg.q_per_kv, t, hd)
    else:
        j0, j1 = kv_window(cfg, hq, tp)
        qg = q.reshape(b, j1 - j0, hq // (j1 - j0), t, hd)
        k, v = k[:, j0:j1], v[:, j0:j1]
    cq = min(cfg.q_chunk, t)
    if t % cq != 0:
        cq = t                                   # ragged tail: one chunk
    skip = causal and cfg.causal_block_skip and cq < t
    k_pos = torch.arange(t, device=x.device)
    outs = []
    for lo in range(0, t, cq):
        klen = lo + cq if skip else t
        s = torch.einsum("bkgtd,bksd->bkgts", qg[:, :, :, lo:lo + cq],
                         k[:, :, :klen]).float() * _scale(cfg)
        s = softcap(s, cfg.attn_softcap)
        s = s + _mask_bias(k_pos[lo:lo + cq], k_pos[:klen], window, causal)
        pr = torch.softmax(s, dim=-1).to(x.dtype)
        outs.append(torch.einsum("bkgts,bksd->bkgtd", pr, v[:, :, :klen]))
    y = torch.cat(outs, dim=3).reshape(b, hq, t, hd).transpose(1, 2).reshape(b, t, -1)
    out = _dense_matmul(p["wo"], y)
    return (out, (k, v)) if return_kv else out


def attention_cross(p: dict, x: torch.Tensor, memory_kv: tuple[torch.Tensor, torch.Tensor],
                    cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Cross attention of x (B, T, d) against the fixed encoder memory K/V
    (B, Hkv, S, hd) each: no RoPE, no mask; float q/o weights. Under ``tp``
    the memory K/V hold every head, the rank's query heads attend over
    their window of them (:func:`kv_window`) and the output is the rank's
    partial sum of ``wo``, which the block reduces."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    q = _dense_matmul(p["wq"], x)
    if cfg.qkv_bias:
        q = q + _own(p["bq"], q, tp)
    hq = q.shape[-1] // hd
    j0, j1 = kv_window(cfg, hq, tp)
    k, v = memory_kv
    if j1 - j0 < cfg.n_kv_heads:
        k, v = k[:, j0:j1], v[:, j0:j1]
    qg = q.reshape(b, t, hq, hd).transpose(1, 2).reshape(b, j1 - j0, hq // (j1 - j0), t, hd)
    s = torch.einsum("bkgtd,bksd->bkgts", qg, k).float() * _scale(cfg)
    pr = torch.softmax(s, dim=-1).to(x.dtype)
    y = torch.einsum("bkgts,bksd->bkgtd", pr, v)
    y = y.reshape(b, hq, t, hd).transpose(1, 2).reshape(b, t, -1)
    return _dense_matmul(p["wo"], y)


def project_memory_kv(p: dict, mem: torch.Tensor, cfg: ModelConfig, tp=None):
    """Encoder memory (B, S, d) -> cross-attention K/V (B, Hkv, S, hd) each,
    computed once per request. Under ``tp`` the rank's K/V columns of the
    column-parallel ``wk``/``wv`` are all-gathered over ``model``
    (:func:`_gather_kv`), so every rank holds every head, as the cache's
    ``cross_k``/``cross_v`` replicate them over ``model``."""
    b, s, _ = mem.shape
    hd = cfg.head_dim
    k = _dense_matmul(p["wk"], mem)
    v = _dense_matmul(p["wv"], mem)
    if cfg.qkv_bias:
        k, v = k + _own(p["bk"], k, tp), v + _own(p["bv"], v, tp)
    if tp is not None and k.shape[-1] < cfg.n_kv_heads * hd:
        k, v = _gather_kv(k, v, tp)
    return (k.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2),
            v.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2))


def _live_start(end: torch.Tensor, window: Optional[int]) -> Optional[torch.Tensor]:
    """A windowed layer's live-range start, ``max(end - window, 0)`` per lane
    (None without a window: the kernels then start at 0)."""
    return None if window is None else (end - window).clamp_min(0).to(torch.int32)


def attention_decode(
    p: dict,
    x: torch.Tensor,            # (B, T, d) — T new tokens (usually 1)
    k_cache: torch.Tensor,      # (B, Hkv, hd, Lmax) column-wise (one layer)
    v_cache: torch.Tensor,      # (B, Hkv, Lmax, hd) row-wise (one layer)
    pos: torch.Tensor,          # (B,) int32 per-lane fill, or a scalar
    cfg: ModelConfig,
    *,
    window: Optional[int] = None,
    gemm: bool = False,
    layout: kv_mapping.Layout = "cdpim",
    tp=None,
) -> torch.Tensor:
    """One step against contiguous dual-layout lanes. The new tokens' K/V are
    written into the lanes IN PLACE; returns the attention block's output
    (B, T, d). A single-token step on the cdpim layout takes the dispatched
    decode-attention kernel over each lane's live range ``[max(end - window,
    0), end)``, end = pos + 1 (``window`` None: from 0); ``T > 1`` (chunked
    admission), ``gemm=True`` (the batch-prefill form, float GEMMs) and the
    fixed-mapping ablation layouts ``row_row``/``col_col`` (``layout``; no
    kernel, as in the JAX package) take the dense masked softmax, the window
    in its mask. Under ``tp`` the lanes take every KV head, the attention
    reads the rank's window of them (:func:`kv_window`) and the output is
    the rank's partial sum of the projection, which the block reduces."""
    b, t, _ = x.shape
    pos_b = torch.as_tensor(pos, device=x.device).to(torch.int32).reshape(-1).expand(b)
    positions = pos_b[:, None] + torch.arange(t, device=x.device, dtype=torch.int32)[None, :]
    lin = _decode_linear(cfg) if (t == 1 and not gemm) else None
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, linear_fn=lin, tp=tp)

    kv_mapping.append_layer(k_cache, v_cache, k_new, v_new, pos_b, layout)
    if tp is not None:
        j0, j1 = kv_window(cfg, q.shape[1], tp)
        k_cache, v_cache = k_cache[:, j0:j1], v_cache[:, j0:j1]

    if t == 1 and not gemm and layout == "cdpim":
        end = pos_b + 1
        o = dispatch.decode_attention(
            q[:, :, 0, :], k_cache, v_cache, end, start=_live_start(end, window),
            scale=_scale(cfg), softcap=cfg.attn_softcap, cfg=cfg)
        y = o.to(x.dtype).reshape(b, 1, -1)
        return lin(p["wo"], y)

    y = _masked_attention(q, k_cache, v_cache, positions, cfg, x.dtype, window, layout)
    return (lin or _dense_matmul)(p["wo"], y)


def attention_prefill(p: dict, x: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, cfg: ModelConfig, *, step: int,
                      window: Optional[int] = None, tp=None) -> torch.Tensor:
    """The prefill's attention over whole prompts x (B, S, d) into empty
    lanes (one layer, cdpim): the projections once (under ``tp`` one K/V
    all-gather), every token's K/V written at slots 0..S-1, then the query
    heads ``step`` at a time against the lanes (under ``tp`` the rank's heads
    against its KV-head window, :func:`kv_window`), masked causally and by
    ``window`` as :func:`attention_decode`'s batch-prefill form masks them.
    Returns the output projection (B, S, d), under ``tp`` the rank's partial
    sum."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device, dtype=torch.int32).expand(b, s)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, tp=tp)
    kv_mapping.append_layer(k_cache, v_cache, k_new, v_new, 0)
    j0, j1 = kv_window(cfg, q.shape[1], tp)
    kw, vw = k_cache[:, j0:j1], v_cache[:, j0:j1]
    y = torch.cat([_masked_attention(q[:, :, lo:lo + step], kw, vw, positions[:, lo:lo + step],
                                     cfg, x.dtype, window) for lo in range(0, s, step)], dim=1)
    return _dense_matmul(p["wo"], y)


def attention_decode_ring(
    p: dict,
    x: torch.Tensor,            # (B, 1, d) — one new token per lane
    k_ring: torch.Tensor,       # (B, Hkv, hd, W) column-wise ring (one layer)
    v_ring: torch.Tensor,       # (B, Hkv, W, hd) row-wise ring (one layer)
    pos: torch.Tensor,          # (B,) int32 absolute position per lane, or a scalar
    cfg: ModelConfig,
) -> torch.Tensor:
    """Sliding-window decode against a RING of exactly W slots (gemma2's local
    layers under ``windowed_kv_cache``). The new token's K/V overwrite slot
    ``pos % W`` of each lane IN PLACE; after the write the ring holds exactly
    the tokens ``(pos - W, pos]``, and softmax does not depend on slot order,
    so the contiguous decode kernel runs over the slot prefix ``[0, min(pos +
    1, W))``. RoPE is applied at absolute positions, so stored K stays valid.
    Returns the attention block's output (B, 1, d)."""
    b, t, _ = x.shape
    if t != 1:
        raise ValueError(f"a ring cache takes one token per step (got {t}); rings are "
                         f"filled by a full prefill (models.model.prefill)")
    w = k_ring.shape[-1]
    hd = cfg.head_dim
    pos_b = torch.as_tensor(pos, device=x.device).to(torch.int32).reshape(-1).expand(b)
    lin = _decode_linear(cfg)
    q, k_new, v_new = _project_qkv(p, x, cfg, pos_b[:, None], linear_fn=lin)
    kv_mapping.append_layer(k_ring, v_ring, k_new, v_new, pos_b % w)
    end = (pos_b + 1).clamp_max(w)
    o = dispatch.decode_attention(q[:, :, 0, :], k_ring, v_ring, end,
                                  scale=_scale(cfg), softcap=cfg.attn_softcap, cfg=cfg)
    y = o.to(x.dtype).reshape(b, 1, cfg.n_heads * hd)
    return lin(p["wo"], y)


def attention_decode_paged(
    p: dict,
    x: torch.Tensor,            # (B, T, d) — T new tokens (usually 1)
    k_pages: torch.Tensor,      # (P, Hkv, hd, Bsz) column-wise pages (one layer)
    v_pages: torch.Tensor,      # (P, Hkv, Bsz, hd) row-wise pages (one layer)
    block_table: torch.Tensor,  # (B, NB) int32 — physical page per logical block
    pos: torch.Tensor,          # (B,) int32: per-lane cache fill
    cfg: ModelConfig,
    *,
    window: Optional[int] = None,
    gemm: bool = False,
) -> torch.Tensor:
    """One step against block-paged dual-layout KV. The new tokens' K/V are
    written into their pages IN PLACE (``k_pages``/``v_pages`` are mutated);
    returns the attention block's output (B, T, d). ``window`` bounds each
    lane's live range as in :func:`attention_decode`.

    ``gemm=True`` is the batch-prefill form (the JAX ``M.prefill`` path): float
    GEMMs and the dense masked attention even for a one-token chunk.
    """
    b, t, _ = x.shape
    hd = cfg.head_dim
    block = k_pages.shape[-1]
    pos_b = pos.to(torch.int32).expand(b)
    positions = pos_b[:, None] + torch.arange(t, device=x.device, dtype=torch.int32)[None, :]
    lin = _decode_linear(cfg) if (t == 1 and not gemm) else None
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, linear_fn=lin)

    kv_mapping.append_layer_paged(k_pages, v_pages, k_new, v_new, pos_b, block_table,
                                  block)

    if t == 1 and not gemm:
        end = pos_b + 1
        o = dispatch.decode_attention_paged(
            q[:, :, 0, :], k_pages, v_pages, block_table, end,
            start=_live_start(end, window),
            scale=_scale(cfg), softcap=cfg.attn_softcap, cfg=cfg)
        y = o.to(x.dtype).reshape(b, 1, cfg.n_heads * hd)
        return lin(p["wo"], y)

    k_cache, v_cache = kv_mapping.materialize_lanes(k_pages, v_pages, block_table)
    y = _masked_attention(q, k_cache, v_cache, positions, cfg, x.dtype, window)
    proj = lin or _dense_matmul
    return proj(p["wo"], y)
