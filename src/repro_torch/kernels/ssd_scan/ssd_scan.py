"""Wrapper of the CUDA SSD chunked-scan kernels (``csrc/ssd_scan.cu``).

CPU tensors take the plain version (:func:`ref.ssd_scan_ref`); CUDA tensors
launch the kernels or raise. ``ssd_scan.launches`` counts calls that launched
(each launches the per-lane scores kernel, then the per-head walk, and for
N over 64 the kernel that sums the column tiles' shares of y).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

SUB_CHUNK = 32      # steps of the kernel's own sub-chunk, whatever the caller's chunk
N_TILE = 64         # state columns one walk block holds in registers
ROW_FLOATS = 64     # floats of an x, b or c row in shared memory


def smem_bytes() -> int:
    """Shared memory of one walk block: two stages of x, b and c tiles
    (SUB_CHUNK x 64 floats each) and a (SUB_CHUNK, SUB_CHUNK) score tile."""
    return 2 * 4 * (3 * SUB_CHUNK * ROW_FLOATS + SUB_CHUNK * SUB_CHUNK)


@functools.lru_cache(maxsize=None)
def _bind():
    fn = _build.library("ssd_scan").ssd_scan_launch
    fn.argtypes = [_build.VP] * 9 + [_build.I32] * 6 + [_build.VP]
    fn.restype = _build.I32
    return fn


def blocks_per_sm() -> int:
    """Walk blocks resident on one SM by the occupancy calculator (its
    shared-memory attributes are set at the first launch, so ask after one)."""
    fn = _build.library("ssd_scan").ssd_scan_blocks_per_sm
    fn.argtypes = [_build.I32]
    fn.restype = _build.I32
    return fn(1)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             s0: torch.Tensor, *, chunk: int):
    """x (B,T,H,P); a (B,T,H); b, c (B,T,N); s0 (B,H,P,N) -> y (B,T,H,P) f32,
    s_final (B,H,P,N) f32. On CUDA, T must be a multiple of ``chunk`` (the op
    pads) and every operand float32; N over ``N_TILE`` takes column tiles."""
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
    if q < 1 or t < 1 or t % q:
        raise ValueError(f"chunk {q} must be at least 1 and divide T={t}")
    x, a, b, c, s0 = (o.contiguous() for o in ops)
    y = torch.empty((bb, t, h, p), dtype=torch.float32, device=x.device)
    s_fin = torch.empty((bb, h, p, n), dtype=torch.float32, device=x.device)
    scores = torch.empty((bb, -(-t // SUB_CHUNK), SUB_CHUNK, SUB_CHUNK),
                         dtype=torch.float32, device=x.device)
    n_tiles = -(-n // N_TILE)
    # the shares of y of column tiles 1.. (N over 64 only), summed into y in order
    y_parts = (torch.empty((n_tiles - 1, bb, t, h, p), dtype=torch.float32, device=x.device)
               if n_tiles > 1 else None)
    code = _bind()(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), s0.data_ptr(),
                   y.data_ptr(), s_fin.data_ptr(), scores.data_ptr(),
                   None if y_parts is None else y_parts.data_ptr(), bb, t, h, p, n, q,
                   torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "ssd_scan")
    ssd_scan.launches += 1
    return y, s_fin


ssd_scan.launches = 0
