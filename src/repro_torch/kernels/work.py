"""Analytic work of the port's kernels, and how a kernel op reports it.

Each formula counts what the kernel's function must do on its inputs: every
input byte read once, every output byte written once, and its operations (two
a multiply-add). ``chip_smoke.py`` divides them by the card's peaks
(``launch.roofline``) for each kernel's ``bound_ms``; the cost counter
(``launch.costrun.CostCounter``) adds them to a cell's count.

:func:`kernel_scope` is how a kernel op (``kernels/*/ops.py``) reports one
call: it hands the call's work to every active counter and then hides the
op's own PyTorch calls (the plain version on the CPU, the wrapper's small
copies on the card) from every dispatch mode, so a cell counts the same on
``meta``, on the CPU and on the card. With no dispatch mode active it costs
one C call.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import _disable_current_modes, _get_current_dispatch_mode_stack


def gemv_work(n: int, k: int, b: int) -> tuple[int, int]:
    """B3: (N, K) int8 weights x (B, K) int8 activations, f32 scales in, (B, N)
    f32 out -> (bytes, int8 operations)."""
    return n * k + b * k + 4 * n + 4 * b + 4 * b * n, 2 * b * n * k


def attn_work(tokens: int, b: int, hkv: int, g: int, hd: int, out_bytes: int, *,
              kv_bytes: int = 2, q_bytes: int = 2) -> tuple[int, int]:
    """B1, B2 stage 1 and B4 over ``tokens`` live (lane, token) pairs summed
    over the batch: their K and V, the queries, the output (``out_bytes``: the
    f32 result, or B2's partials) and the per-lane start and end -> (bytes,
    flops of q.K and p.V)."""
    nbytes = (tokens * hkv * hd * 2 * kv_bytes + b * hkv * g * hd * q_bytes + out_bytes
              + b * 4 * 2)
    return nbytes, 4 * tokens * hkv * g * hd


def merge_work(b: int, hkv: int, splits: int, g: int, hd: int) -> tuple[int, int]:
    """B2 stage 2: read every split's (acc, m, l), write the (B, Hkv, G, hd)
    f32 output -> (bytes, flops)."""
    part_bytes = b * hkv * splits * g * (hd + 2) * 4
    return part_bytes + b * hkv * g * hd * 4, 3 * b * hkv * splits * g * hd


def ssd_chunked_flops(b: int, t: int, q: int, h: int, p: int, n: int,
                      shared_scores: bool) -> int:
    """Flops of the chunked SSD algorithm at chunk ``q``: the scores C B^T and
    the masked intra-chunk product over the visible lower triangle, the
    carried-state product and the state update; the scores once per (lane,
    chunk) where the heads share them."""
    n_chunks = -(-t // q)
    tri = q * (q + 1) // 2
    scores = 2 * b * n_chunks * tri * n * (1 if shared_scores else h)
    return scores + 2 * b * h * n_chunks * (tri * p + 2 * q * p * n)


def ssd_work(b: int, t: int, h: int, p: int, n: int) -> tuple[int, int]:
    """B5: x (B,T,H,P), a (B,T,H), b and c (B,T,N), s0 (B,H,P,N) f32 in, y and
    the final state out -> (bytes, flops of the recurrence: 5*P*N a step and
    head, the definition ``ssd_scan_ref`` computes)."""
    nbytes = 4 * (b * t * h * p * 2 + b * t * h + 2 * b * t * n + 2 * b * h * p * n)
    return nbytes, 5 * b * t * h * p * n


_IDLE = contextlib.nullcontext()


def kernel_scope(name: str, work):
    """Context for one call of kernel ``name``: with a dispatch mode active,
    ``work()`` (-> bytes moved, operations done) goes to every counter among
    them (a mode with a ``kernel_work`` method) and the body runs with every
    dispatch mode off; with none active (serving) it does nothing, and
    ``work`` is never called."""
    if not torch._C._len_torch_dispatch_stack():
        return _IDLE
    return _reported(name, *work())


@contextlib.contextmanager
def _reported(name: str, nbytes: int, ops: int):
    for mode in _get_current_dispatch_mode_stack():
        report = getattr(mode, "kernel_work", None)
        if report is not None:
            report(name, nbytes, ops)
    with _disable_current_modes():
        yield
