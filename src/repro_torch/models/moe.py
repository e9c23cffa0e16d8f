"""Mixture-of-Experts FFN: top-k router + GShard capacity dispatch (port of
``repro.models.moe``).

* :func:`moe_einsum` — the serving path. Tokens are split into groups; within
  a group each (token, pick) takes the next free slot of its expert's
  capacity buffer in token-major order, and picks past ``cap`` drop. The
  keep mask and the combine weights are the JAX package's exactly. The
  dispatch scatters each kept pick's token row into its (expert, slot) row
  (dropped picks land in one trash row that is cut off) and the combine
  gathers the slot rows back, in place of the JAX one-hot einsums; the expert
  FFN is the same batched product over every expert's capacity buffer, so a
  step reads every expert table, as the JAX einsum form does.
* :func:`moe_dense` — the exact all-experts form, every expert on every token
  combined with the router weights (no capacity): the plain version.

Which picks drop depends on every token of the call: how many share it,
their order, pads and dead decode lanes included. Callers that want the JAX
engine's tokens must group tokens as it does (``ModelConfig.token_coupled``).
The expert tables are stacked (E, d, f) and stay float under W8A8, as in the
JAX package (``core.quant`` quantizes 2-D leaves only).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models.layers import dense_init


def init_moe(generator: torch.Generator, cfg: ModelConfig, device) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dtype = torch_dtype(cfg.param_dtype)
    return {
        "router": dense_init(generator, (d, e), dtype, device),
        "w_gate": dense_init(generator, (e, d, f), dtype, device),
        "w_up": dense_init(generator, (e, d, f), dtype, device),
        "w_down": dense_init(generator, (e, f, d), dtype, device),
    }


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest in descending
    order, ties to the lower index. ``torch.topk`` promises no tie order, so
    this is a stable descending sort cut at k."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p: dict, x2d: torch.Tensor, cfg: ModelConfig):
    """x2d (T, d) -> (weights (T, k) in x's dtype, idx (T, k), probs (T, E) f32):
    f32 softmax over ``x2d @ router``, top-k, renormalized over the picks."""
    logits = (x2d @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k(probs, cfg.top_k)
    w = w / w.sum(dim=-1, keepdim=True)
    return w.to(x2d.dtype), idx, probs


def _expert_ffn(p: dict, xe: torch.Tensor) -> torch.Tensor:
    """Each expert's gated MLP over its own rows: xe (..., E, C, d) -> (..., E, C, d)."""
    g = torch.einsum("...ecd,edf->...ecf", xe, p["w_gate"])
    u = torch.einsum("...ecd,edf->...ecf", xe, p["w_up"])
    h = F.silu(g.float()).to(xe.dtype) * u
    return torch.einsum("...ecf,efd->...ecd", h, p["w_down"])


def moe_dense(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Exact all-experts form (tests and the plain version only)."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    w, idx, _ = _router(p, x2d, cfg)
    y_e = _expert_ffn(p, x2d[None].expand(cfg.n_experts, -1, -1))      # (E, T, d)
    comb = torch.zeros((x2d.shape[0], cfg.n_experts), dtype=w.dtype, device=x.device)
    comb.scatter_add_(1, idx, w)                                         # (T, E)
    y = torch.einsum("te,etd->td", comb, y_e)
    return y.reshape(shape)


def capacity(t: int, cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_groups, group size, per-expert capacity) for a call of ``t`` tokens,
    the JAX package's expression verbatim (Python ``round``: halves to even)."""
    sg = min(cfg.moe_group_size, t)
    n_groups = max(t // sg, 1)
    if t % n_groups != 0:
        n_groups, sg = 1, t
    sg = t // n_groups
    cap = int(max(cfg.top_k, round(sg * cfg.top_k / cfg.n_experts * cfg.moe_capacity_factor)))
    cap = min(cap, sg)
    return n_groups, sg, cap


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` (int64), computed the same way on every device:
    ``F.one_hot`` reads its indices to check them on the CPU only, which a
    cost count (``launch.costrun``) would see there and not on the card."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def keep_rule(idx: torch.Tensor, n_experts: int, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """idx (G, S, k) -> (slot (G, S, k), keep (G, S, k)): a pick's slot in its
    expert's buffer is the number of earlier picks of that expert in the group,
    token-major then pick order; it is kept when the slot is below ``cap``."""
    g, s, k = idx.shape
    onehot = one_hot(idx, n_experts).reshape(g, s * k, n_experts)
    before = torch.cumsum(onehot, dim=1) - onehot
    slot = (before * onehot).sum(dim=-1).reshape(g, s, k)
    return slot, slot < cap


def moe_einsum(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """GShard grouped capacity dispatch (the serving path)."""
    shape = x.shape
    d = shape[-1]
    x2d = x.reshape(-1, d)
    t = x2d.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    n_groups, sg, cap = capacity(t, cfg)
    w, idx, _ = _router(p, x2d, cfg)
    w = w.reshape(n_groups, sg, k)
    slot, keep = keep_rule(idx.reshape(n_groups, sg, k), e, cap)
    # row of each pick in the flat (E * cap) buffer; dropped picks -> trash row
    row = torch.where(keep, idx.reshape(n_groups, sg, k) * cap + slot, e * cap)
    row = row.reshape(n_groups, sg * k, 1).expand(-1, -1, d)
    src = x2d.reshape(n_groups, sg, 1, d).expand(-1, -1, k, -1).reshape(n_groups, sg * k, d)
    xe = torch.zeros((n_groups, e * cap + 1, d), dtype=x.dtype, device=x.device)
    xe.scatter_(1, row, src)    # each kept (expert, slot) row receives one token
    ye = _expert_ffn(p, xe[:, :e * cap].reshape(n_groups, e, cap, d))
    ye = torch.cat([ye.reshape(n_groups, e * cap, d),
                    torch.zeros((n_groups, 1, d), dtype=ye.dtype, device=x.device)], dim=1)
    picked = torch.gather(ye, 1, row).reshape(n_groups, sg, k, d)
    y = torch.einsum("gsk,gskd->gsd", w.float(), picked.float()).to(x.dtype)
    return y.reshape(shape)



def aux_load_balance_loss(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balance loss of one router over x (..., d): the
    expert count times the sum over experts of (the share of tokens whose
    first pick it is) x (its mean router probability); 1 for a uniform
    router. ``loss_fn`` feeds it layer 0's router and the final-normed hidden
    states, as the JAX package does."""
    _, idx, probs = _router(p, x.reshape(-1, x.shape[-1]), cfg)
    e = cfg.n_experts
    frac_tokens = one_hot(idx[:, 0], e).float().mean(dim=0)
    return e * (frac_tokens * probs.mean(dim=0)).sum()
