"""Wrapper of the CUDA ``pim_gemv`` kernel (``csrc/pim_gemv.cu``).

CPU tensors take the plain version (:func:`ref.pim_gemv_ref`); CUDA tensors
launch the kernel or raise — there is no fallback. ``pim_gemv.launches``
counts kernel launches (plain-version calls do not count). :func:`plan` says
how the kernel cuts a call (tensor-core tiles and K splits, or the plain
kernel for ragged operands).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pim_gemv.ref import pim_gemv_ref


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("pim_gemv")
    lib.pim_gemv_launch.argtypes = [_build.VP] * 5 + [_build.I32] * 4 + [_build.VP]
    lib.pim_gemv_launch.restype = _build.I32
    lib.pim_gemv_plan.argtypes = [_build.I32] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.pim_gemv_plan.restype = _build.I32
    return lib


def plan(n: int, k: int, b: int, vec: bool = True) -> dict:
    """How the kernel cuts an (N, K) x B call on the current card (its grid
    follows the SM count): ``tensor_cores`` (else the plain kernel), grid
    ``row_tiles`` x ``splits`` (K splits, one cluster per row tile) x
    ``groups`` (batch groups of 8), and ``k_tiles_per_split`` (128-byte K
    tiles). ``vec``: K % 16 == 0 and both operands 16-byte aligned."""
    out = (ctypes.c_int * 5)()
    _build.check(_lib().pim_gemv_plan(n, k, b, int(vec), out), "pim_gemv_plan")
    return dict(zip(("tensor_cores", "row_tiles", "splits", "groups", "k_tiles_per_split"),
                    (bool(out[0]), *out[1:])))


def pim_gemv(w: torch.Tensor, x: torch.Tensor, w_scale: torch.Tensor,
             x_scale: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 × (B, K) int8 → (B, N) f32, any N, K and B (the kernel takes
    groups of 8 batch rows; see :func:`plan`)."""
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
    code = _lib().pim_gemv_launch(w.data_ptr(), x.data_ptr(), w_scale.data_ptr(),
                                  x_scale.data_ptr(), out.data_ptr(), n, k, b, vec, stream)
    _build.check(code, "pim_gemv")
    pim_gemv.launches += 1
    return out


pim_gemv.launches = 0
