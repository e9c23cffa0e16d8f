"""Public SSD-scan op: zero-decay padding to the chunk (port of
``repro.kernels.ssd_scan.ops.ssd_scan_op``). The scan reports its work to an
active cost counter (``kernels.work.kernel_scope``); ``meta`` tensors get
outputs of the right shape and dtype and compute nothing."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
from repro_torch.kernels.work import kernel_scope, ssd_work


def pad_to_chunk(x, a, b, c, q: int):
    """Pad T up to a multiple of ``q`` with zero-input, zero-decay steps
    (``a = 0`` -> ``exp(0) = 1`` keeps the state; ``x = b = 0`` add nothing)."""
    rem = (-x.shape[1]) % q
    if not rem:
        return x, a, b, c
    return (F.pad(x, (0, 0, 0, 0, 0, rem)), F.pad(a, (0, 0, 0, rem)),
            F.pad(b, (0, 0, 0, rem)), F.pad(c, (0, 0, 0, rem)))


def ssd_scan_op(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                s0=None, *, chunk: int = 256):
    """y (B,T,H,P) f32 and the final state (B,H,P,N) f32: a ragged T is padded
    to the chunk, the wrapper runs (the kernel on CUDA, the sequential plain
    version on the CPU) and y is cut back to T."""
    bb, t, h, p = x.shape
    n = b.shape[-1]
    if s0 is None:
        s0 = torch.zeros((bb, h, p, n), dtype=torch.float32, device=x.device)
    q = min(int(chunk), t)
    x, a, b, c = pad_to_chunk(x.float(), a.float(), b.float(), c.float(), q)
    with kernel_scope("ssd_scan", lambda: ssd_work(bb, x.shape[1], h, p, n)):
        if x.device.type == "meta":
            return (torch.empty((bb, t, h, p), dtype=torch.float32, device="meta"),
                    torch.empty((bb, h, p, n), dtype=torch.float32, device="meta"))
        y, s_fin = ssd_scan(x, a, b, c, s0.float(), chunk=q)
    return y[:, :t], s_fin
