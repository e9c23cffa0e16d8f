"""``ServingModel`` — the load-time serving artifact (port of
``repro.serve.serving_model``).

``ServingModel.prepare`` fixes every load-time decision once: the device
(``None`` means CUDA; without a card the caller must pass ``device="cpu"``),
the backend check, and, under ``cfg.quantized_decode``, the weight-stationary
int8 images of the qkv/o/MLP weights (``core.quant.prepare_decode_params``;
not of the audio encoder's or the cross attention's, which decode never
feeds to a GEMV), so decode steps feed the PIM GEMV kernel without
re-quantizing weights. The attention-free ``ssm`` family (rwkv6) decodes
with plain matmuls, so it is never pre-quantized.
The slot pool's dual-layout cache specs (column-wise K ``(.., hd, L)``,
row-wise V ``(.., L, hd)``: the paper's §III-C mapping) are laid out at load
(``cache_specs``), and :meth:`ServingModel.init_pool` allocates them.
Engines are cheap views: ``sm.engine(mode=...)`` — prepare once, serve many.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dispatch, quant
from repro_torch.core.pim_modes import Mode
from repro_torch.device import DeviceLike, resolve_device, tensor_device
from repro_torch.models import model as M
from repro_torch.serve.api import GenerationRequest, GenerationResult


@dataclass
class ServingModel:
    """Load-time artifact: config, float params (GEMM operand), the prepared
    decode tree (``PreparedLinear`` leaves when pre-quantized), and the
    device everything lives on; ``cache_specs`` is the slot pool's layout,
    ``{leaf: (shape, dtype)}`` (``models.model.decode_cache_specs``)."""

    cfg: ModelConfig
    params: dict
    decode_params: dict
    max_len: int
    slots: int
    prequantized: bool
    device: torch.device
    cache_specs: dict

    @classmethod
    def prepare(cls, cfg: ModelConfig, params: dict, *, max_len: int = 256,
                slots: int = 4, prequantize: Optional[bool] = None,
                device: DeviceLike = None) -> "ServingModel":
        """Resolve every load-time decision once; returns the artifact.
        ``params`` must already live on ``device``."""
        dev = resolve_device(device)
        M._check_family(cfg)
        dispatch.resolve_backend(cfg, dev)   # validates the backend for this device
        pdev = tensor_device(params)
        if pdev is None or pdev.type != dev.type:
            raise ValueError(f"params live on {pdev}, the artifact on {dev}: build them "
                             f"with init_params(..., device=) or params_from_numpy(..., device=)")
        if prequantize is None:
            prequantize = cfg.quantized_decode
        prequantize = bool(prequantize) and cfg.family != "ssm"
        decode_params = quant.prepare_decode_params(params) if prequantize else params
        return cls(cfg=cfg, params=params, decode_params=decode_params, max_len=max_len,
                   slots=slots, prequantized=bool(prequantize), device=dev,
                   cache_specs=M.decode_cache_specs(cfg, slots, max_len))

    @property
    def backend(self) -> str:
        """The backend every kernel op of this artifact resolves to on its
        device: ``"kernel"`` on the card, ``"reference"`` on the CPU."""
        return dispatch.resolve_backend(self.cfg, self.device)

    def init_pool(self, slots: Optional[int] = None) -> dict:
        """A fresh slot-pool decode cache in the prepared dual layout on the
        artifact's device, its fill ``pos`` a per-lane (slots,) vector."""
        n = self.slots if slots is None else slots
        cache = M.init_decode_cache(self.cfg, n, self.max_len, device=self.device)
        cache["pos"] = cache["pos"].reshape(-1).expand(n).clone()
        return cache

    def cache_pool(self, *, slots: Optional[int] = None, prefix_cache: bool = True,
                   block_size: int = 8, prefix_pages: Optional[int] = None,
                   paged: Optional[bool] = None, spec_slack: int = 0):
        """A :class:`repro_torch.serve.cache.CachePool` on this artifact's
        device. ``paged=None`` pages whenever KV is the whole cache state
        (the dense, vlm and MoE families); ``paged=False`` forces contiguous
        lanes for A/B comparison; a hybrid's pool, a windowed gemma2's (W-slot
        rings beside its global layers' lanes), rwkv6's (recurrent state
        only) and the audio decoder's (self-KV beside the encoder memory) are
        contiguous either way.
        ``spec_slack`` adds per-lane blocks for speculative verify rounds'
        transient ``k+1`` appends."""
        from repro_torch.serve.cache import CachePool

        return CachePool(self.cfg, self.max_len, self.slots if slots is None else slots,
                         prefix_cache=prefix_cache, block_size=block_size,
                         prefix_pages=prefix_pages, paged=paged, spec_slack=spec_slack,
                         device=self.device)

    def engine(self, *, slots: Optional[int] = None, mode: Mode = Mode.HBCEM,
               chunk: int = 8, prefix_cache: bool = True, spec=None, step_policy=None):
        """A continuous-batching engine view over this artifact. ``spec`` (a
        ``serve.spec.SpecConfig``) enables draft/verify speculative decoding;
        ``step_policy`` (a ``core.pim_modes.StepPolicy``) overrides the static
        ``mode`` pin with a per-step choice."""
        from repro_torch.serve.engine import Engine  # deferred: engine imports us

        return Engine(self.cfg, self.params, max_len=self.max_len,
                      slots=self.slots if slots is None else slots, mode=mode,
                      chunk=chunk, serving=self, prefix_cache=prefix_cache, spec=spec,
                      step_policy=step_policy)

    def generate(self, requests: Sequence[GenerationRequest], *, mode: Mode = Mode.HBCEM,
                 slots: Optional[int] = None, chunk: int = 8,
                 prefix_cache: bool = True, spec=None) -> list[GenerationResult]:
        """One-shot convenience: serve ``requests`` through a fresh engine."""
        return self.engine(slots=slots, mode=mode, chunk=chunk,
                           prefix_cache=prefix_cache, spec=spec).serve(requests)
