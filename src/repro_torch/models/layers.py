"""Shared model layers: norms, RoPE, gated MLP, embeddings, RWKV's token
shift (port of ``repro.models.layers``). Params are plain dicts of tensors."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# init helpers (the JAX package's distributions, drawn from a torch.Generator)
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """N(0, 1) * scale / sqrt(fan_in), drawn in float32, cast to ``dtype``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = (scale if scale is not None else 1.0) / math.sqrt(fan_in)
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return w.mul_(std).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype, device) -> torch.Tensor:
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * p["scale"].float()).to(x.dtype)


def init_layernorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32: the mean of squared deviations (the population
    variance), then scale and bias, cast back to ``x``'s dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (half-split rotation)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, hd); positions: broadcastable to (..., T)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                     # (hd/2,)
    angles = positions[..., None].float() * freqs               # (..., T, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------


def init_mlp(generator, d: int, f: int, dtype, device) -> dict:
    return {
        "w_gate": dense_init(generator, (d, f), dtype, device),
        "w_up": dense_init(generator, (d, f), dtype, device),
        "w_down": dense_init(generator, (f, d), dtype, device),
    }


def mlp(p: dict, x: torch.Tensor, act: str = "silu", linear_fn=None) -> torch.Tensor:
    """``linear_fn(w, x)`` overrides the matmul — the decode path injects the
    dispatched (possibly W8A8 PIM-GEMV) linear from ``core.dispatch``."""
    mm = linear_fn or (lambda w, xx: xx @ w)
    g = mm(p["w_gate"], x)
    u = mm(p["w_up"], x)
    if act != "silu":
        raise ValueError(f"activation {act!r} is not ported (silu only)")
    g = F.silu(g.float()).to(x.dtype)
    return mm(p["w_down"], g * u)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def init_embed(generator, vocab: int, d: int, dtype, device) -> dict:
    return {"w": embed_init(generator, (vocab, d), dtype, device)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["w"][tokens]


def embed_rows(p: dict, tokens: torch.Tensor, lo: int) -> torch.Tensor:
    """The lookup in a vocab shard that holds the table's rows ``[lo, lo +
    rows)``: a token's row where the shard holds it, zeros elsewhere. Summed
    over the shards (an all-reduce) it is the whole table's lookup exactly:
    one shard holds each token."""
    w = p["w"]
    local = tokens - lo
    hit = (local >= 0) & (local < w.shape[0])
    x = w[local.clamp(0, w.shape[0] - 1)]
    return torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_lm_head(generator, d: int, vocab: int, dtype, device) -> dict:
    return {"w": dense_init(generator, (d, vocab), dtype, device)}


def lm_head(p: dict, x: torch.Tensor, softcap: Optional[float] = None) -> torch.Tensor:
    logits = (x @ p["w"]).float()
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def lm_head_tied(embed_p: dict, x: torch.Tensor,
                 softcap: Optional[float] = None) -> torch.Tensor:
    """The LM head of a tied-embedding model: ``x @ embed.T``, then f32 and
    the optional final-logit softcap."""
    logits = (x @ embed_p["w"].T).float()
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def token_shift(x: torch.Tensor) -> torch.Tensor:
    """RWKV-style shift right by one along the time axis of (B, T, D): row t
    holds token t - 1, row 0 zeros."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1, :]
