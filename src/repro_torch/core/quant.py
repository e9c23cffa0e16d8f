"""INT8 W8A8 weight preparation (port of ``repro.core.quant``).

Weights are quantized per output channel once, at load, into the
weight-stationary ``(N, K)`` int8 image the PIM GEMV kernel streams;
activations are quantized per row at run time (``kernels.pim_gemv.ops``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.pim_gemv.ops import pim_gemv_int8
from repro_torch.kernels.pim_gemv.ref import pim_gemv_ref, quantize_ref


class QuantizedLinear(NamedTuple):
    w_q: torch.Tensor      # (N, K) int8
    w_scale: torch.Tensor  # (N,) f32


class PreparedLinear(NamedTuple):
    """A weight leaf prepared at load time for the serving decode path: the
    float weight (the GEMM / prefill operand) beside its weight-stationary
    int8 image and per-output-channel scales."""

    w: torch.Tensor        # (K, N) float — GEMM/prefill operand
    w_q: torch.Tensor      # (N, K) int8 — weight-stationary GEMV operand
    w_scale: torch.Tensor  # (N,) f32 per-output-channel scales


# Leaves routed through the serving decode's dispatched linears.
DECODE_LINEAR_SUFFIXES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# Subtrees that never reach the dispatched decode linears, so int8 images of
# them would be dead weight: the audio encoder runs once per request on the
# float tree, and the cross-attention q/o take the float weights at decode
# (its K/V of the memory are projected at prefill).
PREFILL_ONLY_SUBTREES = ("enc_layers", "cross_attn")


def quantize_weight(w: torch.Tensor) -> QuantizedLinear:
    """w: (K, N) float (row-major weight convention) → (N, K) int8 + scales."""
    wq, ws = quantize_ref(w.T, axis=1)
    return QuantizedLinear(w_q=wq.contiguous(), w_scale=ws.contiguous())


def prepare_decode_params(params, path_suffixes=DECODE_LINEAR_SUFFIXES):
    """Return ``params`` with every decode-linear leaf swapped for a
    :class:`PreparedLinear`, but under the :data:`PREFILL_ONLY_SUBTREES`,
    which are shared as they are. The port's params keep one dict per layer
    (``params["layers"]`` is a list), so stacked layers quantize per layer
    by construction. Unmatched leaves are shared, not copied."""

    def prep(tree):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if k in PREFILL_ONLY_SUBTREES:
                    out[k] = v
                elif (k in path_suffixes and isinstance(v, torch.Tensor)
                        and v.dim() == 2):
                    ql = quantize_weight(v)
                    out[k] = PreparedLinear(w=v, w_q=ql.w_q, w_scale=ql.w_scale)
                else:
                    out[k] = prep(v)
            return out
        if isinstance(tree, list):
            return [prep(v) for v in tree]
        return tree

    return prep(params)


def raw_weight(w) -> torch.Tensor:
    """Float view of a maybe-prepared weight leaf (GEMM/prefill operand)."""
    return w.w if isinstance(w, PreparedLinear) else w


def w8a8_linear(ql: QuantizedLinear, x: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    """x (..., K) float -> (..., N) f32 through the int8 datapath: B3 on CUDA
    tensors, its plain version on the CPU; ``use_kernel=False`` takes the
    plain version on any device (the JAX package's oracle path)."""
    shape = x.shape
    x_q, x_s = quantize_ref(x.reshape(-1, shape[-1]), axis=1)
    gemv = pim_gemv_int8 if use_kernel else pim_gemv_ref
    return gemv(ql.w_q, x_q, ql.w_scale, x_s).reshape(*shape[:-1], -1)


def quant_error(w: torch.Tensor, x: torch.Tensor, device: DeviceLike = None) -> float:
    """Relative error of the W8A8 path against the f32 matmul (an accuracy
    audit; the plain path, as the JAX package's ``use_kernel=False``), with
    ``w`` (K, N) and ``x`` (..., K) on ``device`` (``None``: CUDA)."""
    dev = resolve_device(device)
    w, x = w.to(dev), x.to(dev)
    y_q = w8a8_linear(quantize_weight(w), x, use_kernel=False)
    y = x.float() @ w.float()
    return float(torch.linalg.norm(y_q - y) / torch.linalg.norm(y).clamp_min(1e-9))
