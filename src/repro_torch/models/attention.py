"""Attention: GQA + RoPE over CD-PIM KV, contiguous lanes or block pages (port
of the decode part of ``repro.models.attention``).

Single-token decode steps go through ``core.dispatch`` (the CUDA flash-decode
kernels on the card, the plain versions on the CPU); with
``cfg.quantized_decode`` the decode-time qkv/o projections run as W8A8 PIM
GEMVs. Multi-token chunk-prefill steps gather the lanes and run the dense
masked einsum in plain PyTorch, as the JAX package computes them outside any
Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dispatch, kv_mapping
from repro_torch.core.quant import raw_weight
from repro_torch.device import torch_dtype
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


def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                 linear_fn=None):
    """x (B,T,d) -> q (B,Hq,T,hd), k/v (B,Hkv,T,hd), RoPE applied."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    mm = linear_fn or _dense_matmul
    q = mm(p["wq"], x)
    k = mm(p["wk"], x)
    v = mm(p["wv"], x)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, t, cfg.n_heads, hd).transpose(1, 2)
    k = k.reshape(b, t, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, t, cfg.n_kv_heads, hd).transpose(1, 2)
    q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
    k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def _scale(cfg: ModelConfig) -> float:
    if cfg.attn_scale_override is not None:
        return cfg.attn_scale_override
    return cfg.head_dim ** -0.5


def _masked_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      positions: torch.Tensor, cfg: ModelConfig, dtype) -> torch.Tensor:
    """Dense masked attention of T new tokens against contiguous lanes (the
    JAX package's multi-token decode form): q (B, Hq, T, hd), K (B, Hkv, hd,
    L), V (B, Hkv, L, hd), query positions (B, T). Returns (B, T, Hq*hd)."""
    b, _, t, hd = q.shape
    lmax = k_cache.shape[-1]
    qg = q.reshape(b, cfg.n_kv_heads, cfg.q_per_kv, t, hd)
    s = kv_mapping.read_scores(qg, k_cache, "cdpim").float() * _scale(cfg)
    s = softcap(s, cfg.attn_softcap)
    k_pos = torch.arange(lmax, device=q.device)
    valid = k_pos[None, None, :] <= positions[:, :, None]                 # (B, T, L)
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    s = s + bias[:, None, None, :, :]
    pr = torch.softmax(s, dim=-1).to(dtype)
    y = kv_mapping.read_output(pr, v_cache, "cdpim")
    return y.reshape(b, cfg.n_heads, t, hd).transpose(1, 2).reshape(b, t, -1)


def attention_decode(
    p: dict,
    x: torch.Tensor,            # (B, T, d) — T new tokens (usually 1)
    k_cache: torch.Tensor,      # (B, Hkv, hd, Lmax) column-wise (one layer)
    v_cache: torch.Tensor,      # (B, Hkv, Lmax, hd) row-wise (one layer)
    pos: torch.Tensor,          # (B,) int32 per-lane fill, or a scalar
    cfg: ModelConfig,
    *,
    gemm: bool = False,
) -> torch.Tensor:
    """One step against contiguous dual-layout lanes. The new tokens' K/V are
    written into the lanes IN PLACE; returns the attention block's output
    (B, T, d). A single-token step takes the dispatched decode-attention
    kernel over each lane's live range ``[0, pos + 1)``; ``T > 1`` (chunked
    admission) and ``gemm=True`` (the batch-prefill form) take the dense
    masked softmax with float GEMMs."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    pos_b = torch.as_tensor(pos, device=x.device).to(torch.int32).reshape(-1).expand(b)
    positions = pos_b[:, None] + torch.arange(t, device=x.device, dtype=torch.int32)[None, :]
    lin = _decode_linear(cfg) if (t == 1 and not gemm) else None
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, linear_fn=lin)

    kv_mapping.append_layer(k_cache, v_cache, k_new, v_new, pos_b)

    if t == 1 and not gemm:
        o = dispatch.decode_attention(
            q[:, :, 0, :], k_cache, v_cache, pos_b + 1,
            scale=_scale(cfg), softcap=cfg.attn_softcap, cfg=cfg)
        y = o.to(x.dtype).reshape(b, 1, cfg.n_heads * hd)
        return lin(p["wo"], y)

    y = _masked_attention(q, k_cache, v_cache, positions, cfg, x.dtype)
    return (lin or _dense_matmul)(p["wo"], y)


def attention_decode_paged(
    p: dict,
    x: torch.Tensor,            # (B, T, d) — T new tokens (usually 1)
    k_pages: torch.Tensor,      # (P, Hkv, hd, Bsz) column-wise pages (one layer)
    v_pages: torch.Tensor,      # (P, Hkv, Bsz, hd) row-wise pages (one layer)
    block_table: torch.Tensor,  # (B, NB) int32 — physical page per logical block
    pos: torch.Tensor,          # (B,) int32: per-lane cache fill
    cfg: ModelConfig,
    *,
    gemm: bool = False,
) -> torch.Tensor:
    """One step against block-paged dual-layout KV. The new tokens' K/V are
    written into their pages IN PLACE (``k_pages``/``v_pages`` are mutated);
    returns the attention block's output (B, T, d).

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
            scale=_scale(cfg), softcap=cfg.attn_softcap, cfg=cfg)
        y = o.to(x.dtype).reshape(b, 1, cfg.n_heads * hd)
        return lin(p["wo"], y)

    k_cache, v_cache = kv_mapping.materialize_lanes(k_pages, v_pages, block_table)
    y = _masked_attention(q, k_cache, v_cache, positions, cfg, x.dtype)
    proj = lin or _dense_matmul
    return proj(p["wo"], y)
