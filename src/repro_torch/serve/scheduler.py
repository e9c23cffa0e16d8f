"""Request-level scheduler: the admission queue in front of the Engine (the
port of ``repro.serve.scheduler``).

``auto`` works at two horizons: the queue-level heuristic (:meth:`_pick_mode`
— LBIM when the queue's prefill work, less what the prefix store will skip,
dominates its decode work) sets the engine's baseline pin, and a per-step
:class:`~repro_torch.core.pim_modes.SloAwarePolicy` re-decides every step
from the live signals. A static ``mode_policy`` clears the step policy.

Each request decodes to its own ``max_new_tokens`` (or ``eos_id``) on its own
RNG lane; ``drain()`` returns ``{rid: tokens}`` and keeps the full results on
``Scheduler.results``. With ``max_queue`` set, a submit against a full queue
raises :class:`AdmissionRejected` (reject-on-full). :meth:`cancel` works in
both phases: a queued request is removed and recorded CANCELLED at once; one
inside a running drain is forwarded to ``Engine.cancel`` and honored at the
next step boundary.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.pim_modes import Mode, SloAwarePolicy
from repro_torch.serve.api import (FINISH_CANCELLED, GenerationRequest, GenerationResult,
                                   RequestState, SamplingParams)
from repro_torch.serve.engine import Engine
from repro_torch.serve.errors import AdmissionRejected


@dataclass
class Scheduler:
    engine: Engine
    mode_policy: str = "auto"  # "auto" | "hbcem" | "lbim" | "blocked"
    max_queue: int = 0         # >0: bounded admission, reject-on-full
    queue: list = field(default_factory=list)   # [(rid, GenerationRequest)]
    results: dict = field(default_factory=dict)  # {rid: GenerationResult}
    _next_id: int = 0
    _draining: dict = field(default_factory=dict)  # rid -> in-flight index

    def submit(self, prompt: list[int], max_new: int = 16, *,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               on_token: Optional[Callable[[int], None]] = None,
               priority: int = 0,
               ttft_deadline: Optional[int] = None,
               deadline: Optional[int] = None,
               spec_k: Optional[int] = None,
               arrival_step: int = 0) -> int:
        """Queue one request; returns its request id. ``spec_k`` caps its
        speculative draft depth (0 opts out); ``arrival_step`` places it on the
        engine's arrival plane (deadlines are measured from it)."""
        return self.submit_request(GenerationRequest(
            prompt=prompt, max_new_tokens=max_new, eos_id=eos_id,
            sampling=sampling if sampling is not None else SamplingParams(),
            on_token=on_token, priority=priority,
            ttft_deadline=ttft_deadline, deadline=deadline, spec_k=spec_k,
            arrival_step=arrival_step))

    def submit_request(self, request: GenerationRequest) -> int:
        if self.max_queue > 0 and len(self.queue) >= self.max_queue:
            raise AdmissionRejected(len(self.queue), self.max_queue)
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, request))
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel request ``rid`` wherever it lives; False if unknown or done.
        Queued: removed at once with a CANCELLED result. Inside a running drain
        (from an ``on_token`` callback): forwarded to ``Engine.cancel``."""
        for i, (q, r) in enumerate(self.queue):
            if q == rid:
                self.queue.pop(i)
                self.results[rid] = GenerationResult(
                    prompt_len=len(r.prompt), finish_reason=FINISH_CANCELLED,
                    state=RequestState.CANCELLED)
                return True
        if rid in self._draining:
            self.engine.cancel(self._draining[rid])
            return True
        return False

    def _pick_mode(self) -> Mode:
        if self.mode_policy != "auto":
            return Mode(self.mode_policy)
        # prefix-store hits are prefill the engine will skip; only blocks
        # already stored are discounted, not sharing within the queue
        pool = self.engine.pool
        prefill_work = sum(
            len(r.prompt) - (pool.peek_prefix(r.prompt) if pool is not None else 0)
            for _, r in self.queue)
        decode_work = sum(r.max_new_tokens for _, r in self.queue)
        # compute-intensive queue (TTFT-dominated) -> overlap with LBIM
        return Mode.LBIM if prefill_work >= decode_work else Mode.HBCEM

    def drain(self, eos_id: Optional[int] = None) -> dict[int, list[int]]:
        """Serve the whole queue; returns ``{rid: generated tokens}``. A
        drain-level ``eos_id`` overrides every request's own."""
        if not self.queue:
            return {}
        self.engine.mode = self._pick_mode()
        # auto: the queue-level pick is the baseline; the per-step SLO-aware
        # policy re-decides each step. Static policies clear it.
        self.engine.step_policy = SloAwarePolicy() if self.mode_policy == "auto" else None
        batch = list(self.queue)
        self.queue.clear()
        reqs = [dataclasses.replace(r, eos_id=eos_id) if eos_id is not None else r
                for _, r in batch]
        self._draining = {rid: i for i, (rid, _) in enumerate(batch)}
        try:
            outs: list[GenerationResult] = self.engine.serve(reqs)
        finally:
            self._draining = {}
        self.results = {rid: res for (rid, _), res in zip(batch, outs)}
        return {rid: res.tokens for rid, res in self.results.items()}
