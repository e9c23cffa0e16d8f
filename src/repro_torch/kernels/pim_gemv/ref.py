"""Plain PyTorch version of the PIM GEMV kernel (INT8 W8A8, per-channel scales).

The port of ``repro.kernels.pim_gemv.ref``. It is the CPU path of the wrapper
and the version ``chip_smoke.py`` holds the CUDA kernel against on the card.
"""
from __future__ import annotations

import numpy as np
import torch

# jnp.float32(1.0 / 127.0): the f32-rounded reciprocal. Its product with an f32
# amax is the same whether torch multiplies in f32 or in f64 and rounds, because
# the exact product of two f32 values fits a double.
_INV_127 = float(np.float32(1.0 / 127.0))


def pim_gemv_ref(w: torch.Tensor, x: torch.Tensor, w_scale: torch.Tensor,
                 x_scale: torch.Tensor) -> torch.Tensor:
    """w: (N, K) int8; x: (B, K) int8; w_scale: (N,) f32; x_scale: (B,) f32.

    Returns (B, N) float32 = (x @ w.T) * x_scale[:, None] * w_scale[None, :]
    with exact integer accumulation. The product runs in float64, which is
    exact here (|acc| <= 127^2 * K < 2^53) and works on CUDA, which has no
    integer matmul; the conversion to float32 then rounds the exact integer
    once, as the int32 -> float32 cast does.
    """
    acc = x.to(torch.float64) @ w.to(torch.float64).T
    return acc.to(torch.float32) * x_scale[:, None] * w_scale[None, :]


def quantize_ref(a: torch.Tensor, axis: int = -1):
    """Symmetric per-row int8 quantization: returns (q_int8, scale_f32).

    Bit-identical to ``repro``'s quantizer: the scale is ``max(amax, 1e-8)``
    times the f32 reciprocal of 127 (a multiply, not a division), the
    quotient rounds half to even (``torch.round`` as ``jnp.round``), and the
    clip to [-127, 127] comes before the cast to int8.
    """
    af = a.to(torch.float32)
    amax = af.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) * _INV_127
    q = torch.round(af / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.squeeze(axis)
