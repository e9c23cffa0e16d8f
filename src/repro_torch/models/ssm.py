"""Mamba2 (SSD) block — the sequence mixer of zamba2-7b (port of
``repro.models.ssm``), in plain PyTorch.

Prefill and chunked admission scan with the chunked SSD algorithm
(:func:`ssd_chunked`, a loop over chunks with einsums inside each); decode is
the same function at T = 1, the O(1) recurrent state update. The decode cache
is the SSD state (B, H, P, N) plus the causal-conv tails. The JAX package
reaches no Pallas kernel here either: its model scans with jnp
``ssd_chunked``, and the chunked-scan kernel (``kernels/ssd_scan``) is held
against this function, not called by the model.

Projections stay separate (``w_z`` / ``w_x`` / ``w_bc`` / ``w_dt``), as in
the JAX package, and run as plain matmuls: the W8A8 GEMV path serves the
shared attention block's projections only.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models.layers import dense_init, rmsnorm


def ssm_dims(cfg: ModelConfig, d_model: Optional[int] = None):
    d = d_model or cfg.d_model
    d_inner = cfg.ssm_expand * d
    n_heads = d_inner // cfg.ssm_head_dim
    return d, d_inner, n_heads


def init_ssm(generator: torch.Generator, cfg: ModelConfig, device,
             d_model: Optional[int] = None) -> dict:
    """Random Mamba2 params with the JAX package's distributions, drawn from
    ``generator`` (which must live on ``device``)."""
    d, d_inner, n_heads = ssm_dims(cfg, d_model)
    n = cfg.ssm_state
    dtype = torch_dtype(cfg.param_dtype)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_z": dense_init(generator, (d, d_inner), dtype, device),
        "w_x": dense_init(generator, (d, d_inner), dtype, device),
        "w_bc": dense_init(generator, (d, 2 * n), dtype, device),
        "w_dt": dense_init(generator, (d, n_heads), dtype, device),
        "conv_x": dense_init(generator, (cfg.ssm_conv_width, d_inner), dtype, device,
                             scale=1.0),
        "conv_x_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "conv_bc": dense_init(generator, (cfg.ssm_conv_width, 2 * n), dtype, device,
                              scale=1.0),
        "conv_bc_b": torch.zeros((2 * n,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, float(n_heads), n_heads, **f32)),
        "dt_bias": torch.zeros((n_heads,), **f32),
        "d_skip": torch.ones((n_heads,), **f32),
        "norm": {"scale": torch.ones((d_inner,), dtype=dtype, device=device)},
        "w_out": dense_init(generator, (d_inner, d), dtype, device),
    }


def _causal_conv(w: torch.Tensor, bias: torch.Tensor, seq: torch.Tensor,
                 tail: Optional[torch.Tensor]):
    """Depthwise causal conv over (B, T, C); tail (B, W-1, C) or None.
    Returns (silu(conv), new tail)."""
    width = w.shape[0]
    if tail is None:
        pad = torch.zeros((seq.shape[0], width - 1, seq.shape[-1]), dtype=seq.dtype,
                          device=seq.device)
    else:
        pad = tail.to(seq.dtype)
    xp = torch.cat([pad, seq], dim=1)                      # (B, T+W-1, C)
    t = seq.shape[1]
    out = xp[:, 0:t, :] * w[0][None, None, :]
    for i in range(1, width):
        out = out + xp[:, i:i + t, :] * w[i][None, None, :]
    out = out + bias
    new_tail = xp[:, -(width - 1):, :]
    return F.silu(out.float()).to(seq.dtype), new_tail


def ssd_chunked(xh: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                chunk: int, s0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    xh: (B, T, H, P) inputs (already dt-scaled); a: (B, T, H) log decay per
    step (<= 0); b, c: (B, T, N). Returns y (B, T, H, P) in ``xh``'s dtype and
    the final state (B, H, P, N) f32. A T that is not a multiple of the chunk
    is scanned as one chunk, as in the JAX package.
    """
    bb, t, h, pp = xh.shape
    n = b.shape[-1]
    q = min(chunk, t)
    if t % q != 0:
        q = t
    nchunks = t // q
    xs = xh.reshape(bb, nchunks, q, h, pp)
    as_ = a.reshape(bb, nchunks, q, h)
    bs = b.reshape(bb, nchunks, q, n)
    cs = c.reshape(bb, nchunks, q, n)
    s = (torch.zeros((bb, h, pp, n), dtype=torch.float32, device=xh.device)
         if s0 is None else s0.float())
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    ys = []
    for i in range(nchunks):
        xc, ac = xs[:, i].float(), as_[:, i].float()
        bc, cc = bs[:, i].float(), cs[:, i].float()
        al = torch.cumsum(ac, dim=1)                                  # (B,Q,H)
        ldiff = al[:, :, None, :] - al[:, None, :, :]                 # (B,Q,Q,H)
        # exp of the masked log decays, -inf above the diagonal: the values of
        # the JAX package's where(mask, exp(ldiff), 0), whose backward turns an
        # overflowed exp above the diagonal into NaN gradients (ROADMAP C)
        lmat = torch.exp(ldiff.masked_fill(~mask[None, :, :, None], float("-inf")))
        g = torch.einsum("bqn,bsn->bqs", cc, bc)
        y_intra = torch.einsum("bqs,bqsh,bshp->bqhp", g, lmat, xc)
        y_inter = torch.einsum("bqn,bhpn,bqh->bqhp", cc, s, torch.exp(al))
        decay_to_end = torch.exp(al[:, -1:, :] - al)                  # (B,Q,H)
        s = s * torch.exp(al[:, -1, :])[:, :, None, None] + torch.einsum(
            "bqh,bqhp,bqn->bhpn", decay_to_end, xc, bc)
        ys.append((y_intra + y_inter).to(xh.dtype))
    y = torch.stack(ys, dim=1).reshape(bb, t, h, pp)
    return y, s


def ssm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, state: Optional[dict] = None,
                d_model: Optional[int] = None):
    """Full-sequence Mamba2 block over x (B, T, d), from ``state`` (``ssd``,
    ``conv_x``, ``conv_bc``) or from zeros. Returns (y, new_state); the new
    state's tensors are fresh (the caller writes them where they belong)."""
    _, d_inner, n_heads = ssm_dims(cfg, d_model)
    n = cfg.ssm_state
    hd = cfg.ssm_head_dim
    z = x @ p["w_z"]
    xs_raw = x @ p["w_x"]
    bc_raw = x @ p["w_bc"]
    dt = x @ p["w_dt"]
    tail_x = state["conv_x"] if state is not None else None
    tail_bc = state["conv_bc"] if state is not None else None
    xs, new_tail_x = _causal_conv(p["conv_x"], p["conv_x_b"], xs_raw, tail_x)
    bc, new_tail_bc = _causal_conv(p["conv_bc"], p["conv_bc_b"], bc_raw, tail_bc)
    b = bc[..., :n]
    c = bc[..., n:]
    # jax.nn.softplus is logaddexp(x, 0): no linear cut-over for large x
    dt = torch.logaddexp(dt.float() + p["dt_bias"], torch.zeros((), device=x.device))
    a = -torch.exp(p["a_log"])[None, None, :] * dt                  # log decay (B,T,H)
    xh = xs.reshape(*xs.shape[:2], n_heads, hd)
    xh_dt = xh * dt[..., None].to(xh.dtype)
    s0 = state["ssd"] if state is not None else None
    y, s_fin = ssd_chunked(xh_dt, a, b, c, cfg.ssm_chunk, s0)
    y = y + (p["d_skip"][None, None, :, None] * xh.float()).to(y.dtype)
    y = y.reshape(*xs.shape[:2], d_inner)
    y = rmsnorm(p["norm"], y, cfg.norm_eps) * F.silu(z.float()).to(y.dtype)
    out = y @ p["w_out"]
    dt_x = state["conv_x"].dtype if state is not None else new_tail_x.dtype
    dt_bc = state["conv_bc"].dtype if state is not None else new_tail_bc.dtype
    new_state = {"ssd": s_fin, "conv_x": new_tail_x.to(dt_x),
                 "conv_bc": new_tail_bc.to(dt_bc)}
    return out, new_state


def ssm_decode_step(p: dict, x: torch.Tensor, state: dict, cfg: ModelConfig,
                    d_model: Optional[int] = None):
    """Single-token recurrence: h' = exp(a dt) h + dt x (x) B; y = C . h'. x: (B,1,d)."""
    return ssm_forward(p, x, cfg, state, d_model)


def init_ssm_state(batch: int, cfg: ModelConfig, d_model: Optional[int] = None,
                   device=None) -> dict:
    _, d_inner, n_heads = ssm_dims(cfg, d_model)
    dtype = torch_dtype(cfg.dtype)
    return {
        "ssd": torch.zeros((batch, n_heads, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, cfg.ssm_conv_width - 1, d_inner), dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros((batch, cfg.ssm_conv_width - 1, 2 * cfg.ssm_state),
                               dtype=dtype, device=device),
    }
