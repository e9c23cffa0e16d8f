"""Wrapper of the CUDA ``pim_gemv`` kernel (``csrc/pim_gemv.cu``).

CPU tensors take the plain version (:func:`ref.pim_gemv_ref`); CUDA tensors
launch the kernel or raise — there is no fallback. ``pim_gemv.launches``
counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pim_gemv.ref import pim_gemv_ref

@functools.lru_cache(maxsize=None)
def _bind():
    lib = _build.library("pim_gemv")
    fn = lib.pim_gemv_launch
    fn.argtypes = [_build.VP] * 5 + [_build.I32] * 4 + [_build.VP]
    fn.restype = _build.I32
    return fn


def pim_gemv(w: torch.Tensor, x: torch.Tensor, w_scale: torch.Tensor,
             x_scale: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 × (B, K) int8 → (B, N) f32, any N, K and B (the kernel takes
    groups of 8 batch rows and stages x in K tiles where it does not fit)."""
    n, k = w.shape
    b = x.shape[0]
    if x.shape != (b, k) or w_scale.shape != (n,) or x_scale.shape != (b,):
        raise ValueError(f"pim_gemv shapes: w {tuple(w.shape)} x {tuple(x.shape)} "
                         f"w_scale {tuple(w_scale.shape)} x_scale {tuple(x_scale.shape)}")
    if w.device.type == "cpu":
        return pim_gemv_ref(w, x, w_scale, x_scale)
    if w.device.type != "cuda":
        raise ValueError(f"pim_gemv: unsupported device {w.device}")
    if not all(t.device == w.device for t in (x, w_scale, x_scale)):
        raise ValueError("pim_gemv: all operands must be on one device")
    if w.dtype != torch.int8 or x.dtype != torch.int8:
        raise TypeError(f"pim_gemv takes int8 operands, got {w.dtype}, {x.dtype}")
    if w_scale.dtype != torch.float32 or x_scale.dtype != torch.float32:
        raise TypeError("pim_gemv takes float32 scales")
    if min(n, k, b) < 1:
        raise ValueError(f"pim_gemv: empty operand (N={n}, K={k}, B={b})")
    w, x = w.contiguous(), x.contiguous()
    w_scale, x_scale = w_scale.contiguous(), x_scale.contiguous()
    out = torch.empty((b, n), dtype=torch.float32, device=w.device)
    vec = int(k % 16 == 0 and w.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    code = _bind()(w.data_ptr(), x.data_ptr(), w_scale.data_ptr(),
                   x_scale.data_ptr(), out.data_ptr(), n, k, b, vec, stream)
    _build.check(code, "pim_gemv")
    pim_gemv.launches += 1
    return out


pim_gemv.launches = 0
