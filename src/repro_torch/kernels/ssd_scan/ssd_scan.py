"""Wrapper of the CUDA SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

CPU tensors take the plain version (:func:`ref.ssd_scan_ref`); CUDA tensors
launch the kernel or raise. ``ssd_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

THREADS = 256            # the kernel's block; a chunk's cumsum takes one thread a step
ROW_TILE = 32            # output rows per intra-chunk tile
MAX_SMEM_BYTES = 232448  # dynamic shared memory a block may use on the H100


def smem_bytes(q: int, p: int, n: int) -> int:
    """Shared memory of one block: the chunk's x and b tiles, a c row tile,
    the decay-masked score tile, the (P, N) state and two (Q,) decay rows
    (row strides padded by one float against bank conflicts)."""
    return 4 * (q * (p + 1) + q * (n + 1) + ROW_TILE * (n + 1) + ROW_TILE * q
                + p * (n + 1) + 2 * q)


@functools.lru_cache(maxsize=None)
def _bind():
    fn = _build.library("ssd_scan").ssd_scan_launch
    fn.argtypes = [_build.VP] * 7 + [_build.I32] * 6 + [_build.VP]
    fn.restype = _build.I32
    return fn


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             s0: torch.Tensor, *, chunk: int):
    """x (B,T,H,P); a (B,T,H); b, c (B,T,N); s0 (B,H,P,N) -> y (B,T,H,P) f32,
    s_final (B,H,P,N) f32. On CUDA, T must be a multiple of ``chunk`` (the op
    pads) and every operand float32."""
    bb, t, h, p = x.shape
    n = b.shape[-1]
    if (tuple(a.shape) != (bb, t, h) or tuple(b.shape) != (bb, t, n)
            or tuple(c.shape) != (bb, t, n) or tuple(s0.shape) != (bb, h, p, n)):
        raise ValueError(f"ssd_scan shapes: x {tuple(x.shape)} a {tuple(a.shape)} "
                         f"b {tuple(b.shape)} c {tuple(c.shape)} s0 {tuple(s0.shape)}")
    if x.device.type == "cpu":
        return ssd_scan_ref(x, a, b, c, s0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan takes CUDA tensors, got {x.device}")
    ops = (x, a, b, c, s0)
    if any(o.dtype != torch.float32 for o in ops):
        raise TypeError("ssd_scan kernel takes float32 operands")
    if any(o.device != x.device for o in ops):
        raise ValueError("ssd_scan operands must share one CUDA device")
    q = int(chunk)
    if not 1 <= q <= THREADS or t % q:
        raise ValueError(f"chunk {q} must be in [1, {THREADS}] and divide T={t}")
    if smem_bytes(q, p, n) > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {q} with P={p}, N={n} needs {smem_bytes(q, p, n)} bytes "
                         f"of shared memory (> {MAX_SMEM_BYTES})")
    x, a, b, c, s0 = (o.contiguous() for o in ops)
    y = torch.empty((bb, t, h, p), dtype=torch.float32, device=x.device)
    s_fin = torch.empty((bb, h, p, n), dtype=torch.float32, device=x.device)
    code = _bind()(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), s0.data_ptr(),
                   y.data_ptr(), s_fin.data_ptr(), bb, t, h, p, n, q,
                   torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "ssd_scan")
    ssd_scan.launches += 1
    return y, s_fin


ssd_scan.launches = 0
