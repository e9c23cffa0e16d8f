"""RWKV-6 "Finch" block — data-dependent decay linear attention, attention-free
(port of ``repro.models.rwkv``), in plain PyTorch.

The time mix takes a data-dependent token-shift lerp (a low-rank adapter
producing the five r/k/v/w/g mixes) and the LoRA'd decay
``w = exp(-exp(w0 + tanh(x A) B))``; the WKV recurrence keeps a per-head
(hd × hd) state:

    y_t = r_t · (S_{t-1} + (u ⊙ k_t) v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

The JAX package runs it as a ``lax.scan`` over time and has no Pallas kernel
for it; here it is a loop over T in f32 (:func:`_wkv_scan`). Prefill,
chunked admission and decode all take this one function (decode is T = 1).
No KV cache exists, so the paper's K-col/V-row mapping does not apply, and
the projections stay plain matmuls on the float weights: ``ServingModel``
never quantizes the ``ssm`` family.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models.layers import dense_init, layernorm, token_shift

LORA_MIX = 32
LORA_W = 64
# the recurrent leaves of one layer's decode state (stacked over layers)
STATE_KEYS = ("wkv", "att_tail", "ffn_tail")


def rwkv_dims(cfg: ModelConfig):
    d = cfg.d_model
    hd = 64
    n_heads = d // hd
    return d, n_heads, hd


def init_rwkv_block(generator: torch.Generator, cfg: ModelConfig, device) -> dict:
    """Random block params with the JAX package's distributions, drawn from
    ``generator`` (which must live on ``device``)."""
    d, n_heads, hd = rwkv_dims(cfg)
    dtype = torch_dtype(cfg.param_dtype)

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=device)

    def w(shape, scale=None):
        return dense_init(generator, shape, dtype, device, scale=scale)

    return {
        "mix_base": full((5, d), 0.5),
        "mix_w1": w((d, 5 * LORA_MIX)),
        "mix_w2": w((5, LORA_MIX, d), scale=0.1),
        "w0": full((d,), -6.0, torch.float32),
        "w_a": w((d, LORA_W)),
        "w_b": w((LORA_W, d), scale=0.1),
        "u": full((n_heads, hd), 0.0, torch.float32),
        "wr": w((d, d)), "wk": w((d, d)), "wv": w((d, d)), "wg": w((d, d)),
        "wo": w((d, d)),
        "ln_x": {"scale": full((d,), 1.0), "bias": full((d,), 0.0)},
        # channel mix
        "cm_mix_k": full((d,), 0.5),
        "cm_mix_r": full((d,), 0.5),
        "cm_wk": w((d, cfg.d_ff)),
        "cm_wv": w((cfg.d_ff, d)),
        "cm_wr": w((d, d)),
    }


def _shifted(x: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
    """``token_shift(x)`` with row 0 taken from the previous segment's last
    token ``tail`` (B, d)."""
    x_prev = token_shift(x)
    x_prev[:, 0, :] = tail.to(x.dtype)
    return x_prev


def _ddlerp(p: dict, x: torch.Tensor, x_prev: torch.Tensor) -> list[torch.Tensor]:
    """Data-dependent lerp producing the five mixed inputs (RWKV6). The
    first-stage mix shares ``mix_base[0]`` (the r slot), as in the JAX
    package."""
    dx = x_prev - x
    base = x + dx * p["mix_base"][0]
    lora = torch.tanh(base @ p["mix_w1"]).reshape(*x.shape[:-1], 5, LORA_MIX)
    adj = torch.einsum("...fm,fmd->...fd", lora, p["mix_w2"])     # (..., 5, d)
    mixes = p["mix_base"] + adj
    return [x + dx * mixes[..., i, :] for i in range(5)]


def _wkv_scan(r, k, v, w, u, s0):
    """r/k/v: (B, T, H, hd); w: (B, T, H, hd) decay in (0, 1); u: (H, hd) bonus;
    s0: (B, H, hd, hd) f32, key-major (``S[i, j]``).

    Returns y (B, T, H, hd) f32 and the final state; ``s0`` is not written.
    Each step reads the state before its own update, as the JAX scan does."""
    r, k, v, w = (a.float() for a in (r, k, v, w))
    bonus = u.float()[None, :, :, None]
    s = s0
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]               # (B, H, hd, hd)
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], s + bonus * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def rwkv_time_mix(p: dict, x: torch.Tensor, x_prev_tail: torch.Tensor, s0: torch.Tensor,
                  cfg: ModelConfig):
    """x: (B, T, d); ``x_prev_tail`` (B, d) the previous segment's last token
    (zeros for a fresh lane). Returns (y, new tail, new state)."""
    d, n_heads, hd = rwkv_dims(cfg)
    b, t, _ = x.shape
    xr, xk, xv, xw, xg = _ddlerp(p, x, _shifted(x, x_prev_tail))
    r = (xr @ p["wr"]).reshape(b, t, n_heads, hd)
    k = (xk @ p["wk"]).reshape(b, t, n_heads, hd)
    v = (xv @ p["wv"]).reshape(b, t, n_heads, hd)
    g = F.silu((xg @ p["wg"]).float())
    w_log = p["w0"] + (torch.tanh(xw @ p["w_a"]) @ p["w_b"]).float()
    w = torch.exp(-torch.exp(w_log)).reshape(b, t, n_heads, hd)
    y, s_fin = _wkv_scan(r, k, v, w, p["u"], s0)
    # per-head group norm, population variance, eps 64e-5
    mu = y.mean(dim=-1, keepdim=True)
    var = ((y - mu) ** 2).mean(dim=-1, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + 64e-5)).reshape(b, t, d)
    y = y * p["ln_x"]["scale"].float() + p["ln_x"]["bias"].float()
    y = (y * g).to(x.dtype)
    return y @ p["wo"], x[:, -1, :], s_fin


def rwkv_channel_mix(p: dict, x: torch.Tensor, x_prev_tail: torch.Tensor):
    dx = _shifted(x, x_prev_tail) - x
    xk = x + dx * p["cm_mix_k"]
    xr = x + dx * p["cm_mix_r"]
    k = torch.square(torch.relu(xk @ p["cm_wk"]))
    kv = k @ p["cm_wv"]
    return torch.sigmoid((xr @ p["cm_wr"]).float()).to(x.dtype) * kv, x[:, -1, :]


def init_rwkv_state(batch: int, cfg: ModelConfig, device=None) -> dict:
    d, n_heads, hd = rwkv_dims(cfg)
    dtype = torch_dtype(cfg.dtype)
    return {
        "wkv": torch.zeros((batch, n_heads, hd, hd), dtype=torch.float32, device=device),
        "att_tail": torch.zeros((batch, d), dtype=dtype, device=device),
        "ffn_tail": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def rwkv_block(p: dict, x: torch.Tensor, state: dict, cfg: ModelConfig, ln1: dict,
               ln2: dict, norm_eps: float):
    """Full block: y = x + TM(LN1 x); y = y + CM(LN2 y). Returns (y, state');
    the tails are cast to the state's dtype. ``state`` is not written."""
    h = layernorm(ln1, x, norm_eps)
    att, att_tail, wkv = rwkv_time_mix(p, h, state["att_tail"], state["wkv"], cfg)
    x = x + att
    ffn, ffn_tail = rwkv_channel_mix(p, layernorm(ln2, x, norm_eps), state["ffn_tail"])
    x = x + ffn
    return x, {"wkv": wkv, "att_tail": att_tail.to(state["att_tail"].dtype),
               "ffn_tail": ffn_tail.to(state["ffn_tail"].dtype)}
