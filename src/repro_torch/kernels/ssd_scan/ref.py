"""Plain PyTorch versions of the Mamba2 SSD scan.

:func:`ssd_scan_ref` (port of ``repro.kernels.ssd_scan.ref``) is the sequential
recurrence, the definition the kernel is held against and the CPU path of
:func:`ssd_scan.ssd_scan`. :func:`ssd_subchunk_ref` repeats the CUDA kernel's
own arithmetic (sub-chunks, shared scores, TF32 pieces) so that its precision
scheme can be checked without a card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def ssd_scan_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 s0: torch.Tensor):
    """Sequential SSD recurrence, O(T) steps.

    x: (B,T,H,P) dt-scaled inputs; a: (B,T,H) per-step log decay (<= 0);
    b, c: (B,T,N); s0: (B,H,P,N). Returns y (B,T,H,P) f32 and the final state
    (B,H,P,N) f32: ``s_t = exp(a_t) s_{t-1} + x_t (x) b_t``, ``y_t = s_t . c_t``.
    """
    xf, af, bf, cf = x.float(), a.float(), b.float(), c.float()
    s = s0.float()
    ys = []
    for i in range(x.shape[1]):
        s = s * torch.exp(af[:, i])[:, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", xf[:, i], bf[:, i])
        ys.append(torch.einsum("bhpn,bn->bhp", s, cf[:, i]))
    return torch.stack(ys, dim=1), s


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 stored mantissa bits), to nearest with ties away
    from zero (``cvt.rna.tf32.f32``), by bit masking: add half of the dropped
    13 bits' unit to the magnitude, then clear them."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncate(v: torch.Tensor) -> torch.Tensor:
    """What a tensor core reads of an f32 register given as TF32: its top 19
    bits (the low 13 bits of the mantissa dropped)."""
    return (v.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm(u: torch.Tensor, w: torch.Tensor, pieces: Optional[int]) -> torch.Tensor:
    """u @ w in f32 (``pieces`` None), or as the kernel feeds the tensor cores
    TF32 operands: one piece, tf32(u) tf32(w); three pieces, each operand
    split as hi = tf32(v) and lo = v - hi (read truncated to TF32), summed as
    lo*hi + hi*lo + hi*hi. TF32 products are exact in f32."""
    if pieces is None:
        return u @ w
    uh, wh = tf32_round(u), tf32_round(w)
    if pieces == 1:
        return uh @ wh
    if pieces != 3:
        raise ValueError(f"tf32 pieces must be None, 1 or 3, got {pieces}")
    ul, wl = _tf32_truncate(u - uh), _tf32_truncate(w - wh)
    return ul @ wh + uh @ wl + uh @ wh


def ssd_subchunk_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     s0: torch.Tensor, *, sub_chunk: int = 32,
                     tf32_pieces: Optional[int] = None):
    """The CUDA kernel's arithmetic in plain PyTorch: T walked in sub-chunks of
    ``sub_chunk`` steps (the last padded with zero-decay, zero-input steps),
    per sub-chunk the scores G = C B^T once for all heads, then per head

        y^T = exp(al_t) (S C^T) + X^T (G o L)^T,   L[t, s] = exp(al_t - al_s), s <= t
        S   = exp(al_last) S + (X o w)^T B,         w_s = exp(al_last - al_s)

    with every product's operands in ``tf32_pieces`` TF32 pieces (None: f32).
    Same shapes and results as :func:`ssd_scan_ref`."""
    bb, t, h, p = x.shape
    q = int(sub_chunk)
    rem = (-t) % q
    xf, af, bf, cf = (F.pad(v.float(), (0, 0) * (v.dim() - 2) + (0, rem))
                      for v in (x, a, b, c))
    s = s0.float()
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    zero = torch.zeros((), device=x.device)
    ys = []
    for i in range(0, t + rem, q):
        xc = xf[:, i:i + q].permute(0, 2, 3, 1)                      # (B, H, P, Q)
        bc, cc = bf[:, i:i + q], cf[:, i:i + q]                      # (B, Q, N)
        al = torch.cumsum(af[:, i:i + q], dim=1).transpose(1, 2)     # (B, H, Q)
        g = _mm(cc, bc.transpose(1, 2), tf32_pieces)                 # (B, Q, Q)
        gl = torch.where(tril, g[:, None] * torch.exp(
            torch.where(tril, al[..., :, None] - al[..., None, :], zero)), zero)
        inter = _mm(s, cc.transpose(1, 2)[:, None], tf32_pieces) * torch.exp(al)[:, :, None]
        ys.append(inter + _mm(xc, gl.transpose(-1, -2), tf32_pieces))   # (B, H, P, Q)
        al_last = al[..., -1:]
        w = torch.exp(al_last - al)[:, :, None]                      # (B, H, 1, Q)
        s = s * torch.exp(al_last)[..., None] + _mm(xc * w, bc[:, None], tf32_pieces)
    y = torch.cat(ys, dim=-1).permute(0, 3, 1, 2)[:, :t]
    return y.contiguous(), s
