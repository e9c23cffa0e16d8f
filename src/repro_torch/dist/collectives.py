"""Gradient-compression collectives (port of ``repro.dist.collectives``).

Data-parallel gradient all-reduces dominate inter-pod traffic at 512 chips.
INT8 compression with per-row symmetric scales (the same quantization the
CD-PIM CU applies to weights and activations, paper §III) cuts those bytes 4x
against f32 (2x against bf16). Used with error feedback (the caller
accumulates the residual ``g - dequantize(quantize(g))`` into the next step)
the compression is unbiased over time. As in the JAX package there is no
compressed all-reduce: these are the two halves of one, on one rank.
"""
from __future__ import annotations

import torch


def quantize_grad(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row INT8 quantization of a gradient tensor.

    Returns ``(q_int8, scale_f32)`` with ``scale`` keeping the reduced axis
    (keepdims) so :func:`dequantize_grad` is a plain broadcast multiply.
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    gf = g.float()
    amax = gf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.round(gf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_grad(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_grad` (exact up to the rounding step)."""
    return q.float() * scale
