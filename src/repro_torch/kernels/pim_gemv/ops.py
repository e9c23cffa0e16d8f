"""Public W8A8 ops over the PIM GEMV kernel (port of ``repro.kernels.pim_gemv.ops``).

The JAX package padded N and K to its tile grid; the CUDA kernel masks the
ragged edges itself, so there is no padding pass here. Each call reports its
work to an active cost counter (``kernels.work.kernel_scope``); ``meta``
tensors get an output of the right shape and dtype and compute nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pim_gemv.pim_gemv import pim_gemv
from repro_torch.kernels.pim_gemv.ref import quantize_ref
from repro_torch.kernels.work import gemv_work, kernel_scope


def pim_gemv_int8(w_q: torch.Tensor, x_q: torch.Tensor, w_scale: torch.Tensor,
                  x_scale: torch.Tensor) -> torch.Tensor:
    """(N,K) int8 × (B,K) int8 → (B,N) f32 (kernel on CUDA, plain on CPU,
    shapes only on ``meta``)."""
    (n, k), b = w_q.shape, x_q.shape[0]
    with kernel_scope("pim_gemv", lambda: gemv_work(n, k, b)):
        if w_q.device.type == "meta":
            return torch.empty((b, n), dtype=torch.float32, device="meta")
        return pim_gemv(w_q, x_q, w_scale, x_scale)


def linear_w8a8(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Float-in/float-out W8A8 linear: quantize both sides, int8 GEMV, dequant.

    w: (N, K) float (weight-stationary); x: (B, K) float → (B, N) float32.
    """
    w_q, w_s = quantize_ref(w, axis=1)
    return linear_w8a8_prequant(w_q, w_s, x)


def linear_w8a8_prequant(w_q: torch.Tensor, w_scale: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """W8A8 linear against a weight quantized once at load time: only the
    activation is quantized per step. w_q: (N, K) int8; w_scale: (N,) f32;
    x: (B, K) float → (B, N) float32."""
    x_q, x_s = quantize_ref(x, axis=1)
    return pim_gemv_int8(w_q, x_q, w_scale, x_s)
