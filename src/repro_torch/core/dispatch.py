"""Backend dispatch for the decode hot path (port of ``repro.core.dispatch``).

``ModelConfig.attn_backend`` governs every kernel of the decode path:

* ``"auto"``      — follows the tensor's device: the CUDA kernel for CUDA
  tensors, the plain PyTorch version for CPU tensors;
* ``"reference"`` — the plain version; accepted only on the CPU, because on
  CUDA the port never serves from the plain version in place of a kernel;
* ``"pallas"`` / ``"interpret"`` — TPU backends of the JAX package; they raise.

``meta`` tensors (a cost count, ``launch.costrun``) resolve to ``"meta"``: the
kernel ops return shapes and compute nothing. The engine and its ladder
refuse ``meta``.

There is no silent kernel -> reference rung: a kernel that fails on a CUDA
tensor raises.

**Degradation ladder.** The JAX package walks each op down
``pallas -> interpret -> reference`` on a kernel fault or a NaN trip and
retries the step. The TPU's ``interpret`` rung has no CUDA counterpart, and
the port allows no plain-version rung on CUDA tensors, so here each op
(:data:`LADDER_OPS`) has exactly one rung, its resolved backend: ``"kernel"``
on the card, ``"reference"`` on the CPU. :class:`DegradationLadder` keeps the
JAX package's health counters and ``kernel_live`` (True only on the card);
having no rung to fall to, it has no ``degrade``. A failed step therefore
takes the engine's exhaustion path: its participants fail with a typed error
and the engine keeps serving. The JAX engine at its own floor (``reference``,
``auto`` on the CPU) behaves exactly so.

``quantized_decode`` routes decode-time linear projections (qkv / o / MLP)
through the W8A8 PIM GEMV whenever the activation is a low-batch
single-token GEMV shape (``T == 1 and B <= quant_decode_max_batch``).
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import PreparedLinear, raw_weight
from repro_torch.kernels.decode_attention.ops import (decode_attention_op,
                                                      decode_attention_paged_op)
from repro_torch.kernels.pim_gemv.ops import linear_w8a8, linear_w8a8_prequant

BACKENDS = ("auto", "reference")
_TPU_BACKENDS = ("pallas", "interpret")


def resolve_backend(cfg, device) -> str:
    """Concrete backend for tensors on ``device``: ``"kernel"`` (CUDA),
    ``"reference"`` (CPU) or ``"meta"`` (shapes only). Unknown names raise; so
    does ``reference`` on CUDA and any TPU backend. The wrappers themselves
    follow the tensor's device; this validates ``cfg.attn_backend`` against
    it."""
    name = cfg.attn_backend
    if name in _TPU_BACKENDS:
        raise ValueError(f"backend {name!r} is a TPU (Pallas) backend; the PyTorch "
                         f"port takes {BACKENDS}")
    if name not in BACKENDS:
        raise ValueError(f"attn_backend={name!r} unknown; expected one of {BACKENDS}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if name == "reference":
            raise ValueError("backend 'reference' is CPU-only: CUDA tensors always "
                             "run the CUDA kernels")
        return "kernel"
    if dev.type == "cpu":
        return "reference"
    if dev.type == "meta":
        return "meta"
    raise ValueError(f"unsupported device {dev}")


LADDER_OPS = ("decode_attention", "pim_gemv")


class DegradationLadder:
    """Per-op rung and health counters for one engine. Each op's one rung is
    its resolved backend for the engine's device, so there is never a rung to
    fall to: the engine fails the step's participants instead of retrying,
    and ``fallbacks`` stays 0 (kept so ``health()`` has the JAX package's
    shape). ``record_nan`` and ``record_fault`` feed the counters
    ``Engine.health()`` reports."""

    def __init__(self, cfg, device):
        if torch.device(device).type == "meta":
            raise ValueError("the engine does not run on meta tensors: count a cell "
                             "through the model functions (launch.costrun)")
        self._base = {op: resolve_backend(cfg, device) for op in LADDER_OPS}
        self.counters = {op: {"fallbacks": 0, "nan_trips": 0, "kernel_faults": 0}
                         for op in LADDER_OPS}

    def backend(self, op: str) -> str:
        return self._base[op]

    def kernel_live(self, op: str) -> bool:
        """True while ``op`` runs a kernel (only there can a kernel fault
        originate): on the card, never on the CPU."""
        return self._base[op] == "kernel"

    def record_nan(self, op: str = "decode_attention") -> None:
        self.counters[op]["nan_trips"] += 1

    def record_fault(self, op: str) -> None:
        self.counters.setdefault(op, {"fallbacks": 0, "nan_trips": 0, "kernel_faults": 0})
        self.counters[op]["kernel_faults"] += 1

    def health(self) -> dict:
        """JSON-safe per-op snapshot for ``Engine.health()``."""
        return {op: {"backend": self._base.get(op, "?"), "base": self._base.get(op, "?"), **c}
                for op, c in self.counters.items()}


def decode_attention(q, k_cache, v_cache, end, *, start=None, scale: float, softcap=None,
                     cfg) -> torch.Tensor:
    """Dispatched decode attention over contiguous lanes, K (B, Hkv, hd, Lmax)
    column-wise and V (B, Hkv, Lmax, hd) row-wise, each lane over ``[start,
    end)`` (``start`` None: from 0). Returns (B, Hq, hd) float32."""
    resolve_backend(cfg, q.device)   # validates; the wrapper follows the device
    return decode_attention_op(q, k_cache, v_cache, end, start=start, scale=scale,
                               softcap=softcap)


def decode_attention_paged(q, k_pages, v_pages, block_table, end, *, start=None,
                           scale: float, softcap=None, cfg) -> torch.Tensor:
    """Dispatched block-paged decode attention. ``cfg.decode_kv_splits > 1``
    selects the two-stage split-KV reduction. Returns (B, Hq, hd) float32."""
    resolve_backend(cfg, q.device)   # validates; the wrapper follows the device
    return decode_attention_paged_op(
        q, k_pages, v_pages, block_table, end, start=start, scale=scale,
        softcap=softcap, num_splits=getattr(cfg, "decode_kv_splits", 1))


def _gemv_shaped(cfg, x: torch.Tensor) -> bool:
    """Low-batch single-token decode activation (B, 1, d)."""
    return (cfg.quantized_decode and x.dim() == 3 and x.shape[1] == 1
            and x.shape[0] <= cfg.quant_decode_max_batch)


def quantizes_at(cfg, batch: int, t: int) -> bool:
    """Would :func:`linear` route a ``(batch, t, d)`` activation through the
    W8A8 PIM-GEMV path under ``cfg``?"""
    return bool(cfg.quantized_decode and t == 1
                and batch <= cfg.quant_decode_max_batch)


def linear(w, x: torch.Tensor, cfg) -> torch.Tensor:
    """``x @ w`` with the W8A8 PIM-GEMV path at quantized-decode GEMV shapes.

    ``w`` is a raw (K, N) float tensor or a :class:`PreparedLinear` built at
    load time (only the activation is quantized per step); raw leaves
    quantize the weight on the fly, token-identically."""
    if not _gemv_shaped(cfg, x):
        return x @ raw_weight(w)
    resolve_backend(cfg, x.device)
    b, t, k = x.shape
    if isinstance(w, PreparedLinear):
        y = linear_w8a8_prequant(w.w_q, w.w_scale, x.reshape(b * t, k))
    else:
        y = linear_w8a8(w.T, x.reshape(b * t, k))
    return y.reshape(b, t, -1).to(x.dtype)


def mlp(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Gated MLP through the dispatched (possibly W8A8) linears."""
    from repro_torch.models import layers as L  # local import: avoid a cycle at init
    return L.mlp(p, x, linear_fn=lambda w, xx: linear(w, xx, cfg))


def projected_decode_attn_bytes(batch: int, n_kv_heads: int, head_dim: int, lmax: int,
                                pos: int, *, block_l: int = 512, itemsize: int = 2,
                                dispatched: bool = True) -> int:
    """Decode-step cache traffic model for one attention layer (the JAX
    package's, int for int): the dispatched kernel streams only the live K/V
    tiles of ``block_l`` tokens, so its traffic follows ``pos``; the dense path
    reads the whole ``Lmax`` cache every step."""
    bl = min(block_l, lmax)
    if dispatched:
        live_tiles = -(-max(pos, 0) // bl)            # ceil(pos / BL)
        cols = min(live_tiles * bl, -(-lmax // bl) * bl)
    else:
        cols = lmax
    return 2 * batch * n_kv_heads * head_dim * cols * itemsize  # K + V streams
