"""Inference engine: slot-level continuous batching with BLOCKED/HBCEM/LBIM
(port of ``repro.serve.engine``, greedy main path).

``Engine.serve(requests)`` takes ``GenerationRequest`` objects and returns
index-aligned ``GenerationResult`` objects. The decode cache is a
:class:`~repro_torch.serve.cache.CachePool` (fully paged for the dense
family, contiguous lanes for the hybrid or with ``paged=False``); the head of
the queue is chunk-prefilled ahead into a staging stream and dropped into the
next freed lane:

* **LBIM**    — the admission chunk rides in the same step as the decode
  (``core.interleave.fused_step``; the paper's MACT_LDB/MACB_LDT split);
* **HBCEM**   — decode at full internal bandwidth, then the admission chunk
  as a separate step half;
* **BLOCKED** — admission preempts: decodes stall until the pending request
  is fully loaded.

Prefix reuse, per-request ``max_new_tokens``/``eos_id`` retirement, the
starvation-aware admission quantum, ``RequestState`` transitions and the
``ScheduleEvent`` stream follow the JAX engine exactly, so both engines give
the same tokens, states and events for the same requests.

Not ported yet, and refused with ``NotImplementedError`` rather than ignored:
sampled decoding (``temperature > 0``), priorities and preemption, deadlines,
``arrival_step > 0``, speculative decoding, fault plans and the degradation
ladder, per-step mode policies. A step with non-finite logits raises
:class:`~repro_torch.serve.errors.KernelFault`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import interleave
from repro_torch.core.pim_modes import Mode, StepPlan, plan_step
from repro_torch.device import tensor_device
from repro_torch.serve import sampling
from repro_torch.serve.api import (FINISH_EOS, FINISH_FAILED, FINISH_LENGTH,
                                   TERMINAL_STATES, GenerationRequest, GenerationResult,
                                   RequestState)
from repro_torch.serve.cache import CachePool
from repro_torch.serve.errors import EngineStateError, KernelFault
from repro_torch.serve.serving_model import ServingModel


@dataclass
class ScheduleEvent:
    """One engine step, with the fields of the JAX engine's event that the
    ported path fills (spec / fault / ladder fields wait for their slices)."""
    plan: StepPlan
    decode_batch: int       # active decode lanes this step
    prefill_tokens: int     # admission-prefill tokens consumed this step
    decode_ctx: int = 0     # max context (cache fill) among active lanes
    reused_tokens: int = 0  # prompt tokens served from the prefix store
    kv_splits: int = 1      # paged decode KV-split fan-out
    mode: str = ""          # governing Mode this step
    arrivals: int = 0       # requests that became visible at this boundary
    queue_depth: int = 0    # arrived-but-unadmitted requests after arrivals
    emitted_tokens: int = 0  # tokens emitted at this event's boundary
    first_tokens: int = 0    # requests whose FIRST token emitted here
    step_s: float = 0.0      # host seconds from the step's launch to its tokens
    #                          on the host (the step ends in a device sync)


class ScheduleReport(dict):
    """``schedule_report()``'s dict plus a JSON-safe export."""

    def to_json(self) -> dict:
        out = dict(self)
        out["modes"] = sorted(out["modes"])
        return out


def _finite(logits, active, pre_logits) -> bool:
    """NaN/Inf logit guard over positions that can become tokens: ACTIVE
    decode lanes and the admission chunk's final position."""
    if logits is not None and active:
        if not bool(torch.isfinite(logits[active]).all()):
            return False
    if pre_logits is not None:
        if not bool(torch.isfinite(pre_logits[:, -1:, :]).all()):
            return False
    return True


def _unsupported(r: GenerationRequest) -> Optional[str]:
    """Why the ported engine cannot serve ``r`` yet (None: it can)."""
    if r.sampling.temperature > 0:
        return ("sampled decoding (temperature > 0) needs the threefry/fold_in "
                "port (ROADMAP A.1); only greedy requests are served")
    if r.priority != 0:
        return "priorities and preemption are not ported yet (ROADMAP A.3)"
    if r.ttft_deadline is not None or r.deadline is not None:
        return "deadlines are not ported yet (ROADMAP A.4)"
    if r.arrival_step != 0:
        return "arrival_step > 0 (the traffic plane) is not ported yet (ROADMAP A.4)"
    if r.spec_k is not None:
        return "speculative decoding is not ported yet (ROADMAP A.5)"
    return None


@dataclass
class _Prefill:
    """One in-flight chunked admission; ``off`` starts beyond a prefix hit."""
    req: int
    toks: np.ndarray        # (1, n) full prompt
    cache: dict             # batch-1 staging cache being filled chunk by chunk
    off: int = 0
    reused: int = 0

    @property
    def remaining(self) -> int:
        return self.toks.shape[1] - self.off


@dataclass
class _Ready:
    """A fully prefilled request parked until a lane frees."""
    req: int
    cache: dict
    first_tok: int
    reused: int = 0
    prompt: list = field(default_factory=list)
    ctx: int = 0


@dataclass
class Engine:
    cfg: ModelConfig
    params: dict
    max_len: int = 256
    slots: int = 4
    mode: Mode = Mode.HBCEM
    chunk: int = 8
    events: list = field(default_factory=list)
    serving: Optional[ServingModel] = None
    prefix_cache: bool = True
    pool: Optional[CachePool] = None
    nan_guard: bool = True                  # finite-logits check per step
    step_limit: Optional[int] = None        # watchdog; None -> sized from work

    def __post_init__(self) -> None:
        if self.serving is None:
            self.serving = ServingModel.prepare(
                self.cfg, self.params, max_len=self.max_len, slots=self.slots,
                device=tensor_device(self.params))
        self.cfg = self.serving.cfg
        self.params = self.serving.params
        self.max_len = self.serving.max_len
        if self.pool is None:
            # prefix blocks align with the admission chunk so a reuse run's
            # chunk boundaries match a cold run's exactly
            self.pool = self.serving.cache_pool(slots=self.slots,
                                                prefix_cache=self.prefix_cache,
                                                block_size=self.chunk)
        elif self.pool.n_slots != self.slots:
            raise ValueError(f"pool has {self.pool.n_slots} slots, engine expects {self.slots}")
        elif self.pool.prefix_cache and self.pool.block_size != self.chunk:
            raise ValueError(f"pool block_size={self.pool.block_size} must equal engine "
                             f"chunk={self.chunk} when prefix caching is on")
        self.prefix_cache = self.pool.prefix_cache
        self.last_results: Optional[list[GenerationResult]] = None
        self._last_ev: Optional[ScheduleEvent] = None
        self._arrived_unstamped = 0
        self._queue_depth = 0
        self._clock = 0

    def _require(self, cond: bool, msg: str) -> None:
        if not cond:
            raise EngineStateError(msg)

    def _push_event(self, ev: ScheduleEvent) -> None:
        if not ev.mode:
            ev.mode = self.mode.value
        ev.arrivals, self._arrived_unstamped = self._arrived_unstamped, 0
        ev.queue_depth = self._queue_depth
        self.events.append(ev)
        self._clock += 1
        self._last_ev = ev

    def _tokens(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64), device=self.serving.device)

    # ------------------------------------------------------------------ API

    def serve(self, requests: Sequence[GenerationRequest]) -> list[GenerationResult]:
        """Serve ``requests`` through the persistent decode pool. Each request
        decodes to its own ``max_new_tokens``, retires the step it emits its
        ``eos_id`` (the EOS token is included), and streams through
        ``on_token`` if set. On return every result is terminal."""
        self._require(self.serving is not None and self.pool is not None,
                      "Engine not prepared: serving artifact / cache pool missing")
        reqs = list(requests)
        for r in reqs:
            r.validate(self.max_len)
            why = _unsupported(r)
            if why is not None:
                raise NotImplementedError(why)
        n = len(reqs)
        self._reqs = reqs
        self._eos = [r.eos_id if r.eos_id is not None else self.cfg.eos_id for r in reqs]
        results = [GenerationResult(prompt_len=len(r.prompt), arrival_step=r.arrival_step)
                   for r in reqs]
        self._results = results

        self.events.clear()
        pool = self.pool
        pool.reset()  # fresh lanes + slot table; the prefix store survives
        pending: list[int] = list(range(n))
        queue: list[int] = []
        cur_tok = np.zeros((self.slots,), np.int32)
        stream: Optional[_Prefill] = None
        ready: Optional[_Ready] = None
        self._pending_reuse = 0
        self._clock = 0
        self._arrived_unstamped = 0
        self._queue_depth = 0
        self._last_ev = None
        iters = 0
        limit = self.step_limit if self.step_limit is not None else (
            64 + 8 * sum(len(r.prompt) + r.max_new_tokens for r in reqs))

        def emit(si: int, tok: int) -> None:
            """Record one token for slot ``si``; retire the lane when done."""
            s = pool.get(si)
            r = reqs[s.req]
            res = results[s.req]
            res.tokens.append(tok)
            if res.first_token_step is None:
                res.first_token_step = self._clock
                if self._last_ev is not None:
                    self._last_ev.first_tokens += 1
            if self._last_ev is not None:
                self._last_ev.emitted_tokens += 1
            if r.on_token is not None:
                r.on_token(tok)
            s.emitted += 1
            s.ctx += 1
            eos = self._eos[s.req]
            if eos is not None and tok == eos:
                res.finish_reason = FINISH_EOS
            elif s.emitted >= s.budget:
                res.finish_reason = FINISH_LENGTH
            else:
                return
            res.state = RequestState.FINISHED
            res.finish_step = self._clock
            pool.retire(si)

        def place(rdy: _Ready) -> None:
            """Drop a fully prefilled request into the first free lane."""
            r = rdy.req
            si = pool.alloc(reqs[r], r, reused_tokens=rdy.reused, ctx=rdy.ctx,
                            emitted=len(results[r].tokens))
            pool.insert(si, rdy.cache, prompt=rdy.prompt or None)
            results[r].reused_prefix_tokens += rdy.reused
            results[r].state = RequestState.RUNNING
            cur_tok[si] = rdy.first_tok
            emit(si, rdy.first_tok)

        def admit_arrivals() -> None:
            while pending:
                r = pending.pop(0)
                queue.append(r)
                self._arrived_unstamped += 1

        while queue or pending or stream is not None or ready is not None \
                or pool.has_work():
            iters += 1
            if iters > limit:
                for r in range(n):  # watchdog: nothing hangs, ever
                    if results[r].state not in TERMINAL_STATES:
                        results[r].state = RequestState.FAILED
                        results[r].finish_reason = FINISH_FAILED
                        results[r].error = f"watchdog: step limit {limit} exceeded"
                        results[r].finish_step = self._clock
                break
            admit_arrivals()
            self._queue_depth = len(queue)

            # -- a parked request takes the first freed lane
            if ready is not None and pool.free_slots():
                place(ready)
                ready = None
                continue

            active = pool.active_slots()
            if not (queue or stream is not None or ready is not None or active):
                break

            # -- drained pool, nothing staged: batch-prefill straight into lanes
            if not active and stream is None and ready is None and queue:
                if self._admit_batch(queue, cur_tok, emit):
                    continue

            # -- stage the next pending request (one admission in flight)
            if stream is None and ready is None and queue:
                r = queue.pop(0)
                self._queue_depth = len(queue)
                results[r].state = RequestState.ADMITTED
                if results[r].admit_step is None:
                    results[r].admit_step = self._clock
                p = list(reqs[r].prompt) + results[r].tokens
                staging, skip = pool.stage_admission(p)
                self._pending_reuse += skip
                stream = _Prefill(req=r, toks=np.asarray([p], np.int32), cache=staging,
                                  off=skip, reused=skip)

            # starvation-aware admission rate: each FREE lane is wasted decode
            # bandwidth, so the quantum grows with the number of empty lanes
            # (1x when the stream merely runs ahead of retirement, up to
            # `slots`x when the pool is starved). Quanta are whole multiples of
            # `chunk` with at most one sub-chunk tail per prompt.
            c = 0
            if stream is not None:
                boost = max(1, len(pool.free_slots()))
                if stream.remaining >= self.chunk:
                    c = self.chunk * min(boost, stream.remaining // self.chunk)
                else:
                    c = stream.remaining
            plan = plan_step(self.mode, bool(active), stream is not None, c)
            if stream is not None and c > 0:
                stream.cache = pool.staging_step_prep(stream.cache, c)

            t_step = time.perf_counter()
            dparams = self.serving.decode_params
            logits = pre_logits = new_cache = new_scache = None
            feed = self._tokens(cur_tok[:, None])
            if plan.fused:
                self._require(stream is not None,
                              "fused step planned without an admission stream in flight")
                chunk_toks = self._tokens(stream.toks[:, stream.off:stream.off + c])
                logits, new_cache, pre_logits, new_scache = interleave.fused_step(
                    dparams, pool.views(), feed, stream.cache, chunk_toks, self.cfg,
                    sub_chunk=self.chunk)
            else:
                if plan.decode:
                    logits, new_cache = interleave.decode_only_step(
                        dparams, pool.views(), feed, self.cfg)
                if plan.prefill_chunk:
                    self._require(stream is not None,
                                  "prefill chunk planned without an admission stream")
                    chunk_toks = self._tokens(stream.toks[:, stream.off:stream.off + c])
                    pre_logits, new_scache = interleave.prefill_chunk_step(
                        dparams, stream.cache, chunk_toks, self.cfg, sub_chunk=self.chunk)
            if self.nan_guard and not _finite(logits, active, pre_logits):
                raise KernelFault("decode_attention",
                                  "non-finite logits (NaN/Inf guard trip); the port has "
                                  "no degradation ladder yet (ROADMAP A.2)")

            ev = ScheduleEvent(
                plan, len(active), c if plan.prefill_chunk else 0,
                max((pool.get(i).ctx for i in active), default=0),
                self._take_reuse(), mode=self.mode.value,
                kv_splits=(max(1, self.cfg.decode_kv_splits)
                           if plan.decode and pool.paged else 1))
            self._push_event(ev)

            if new_cache is not None:
                pool.commit(new_cache)
            if new_scache is not None:
                stream.cache = new_scache
                stream.off += c

            if plan.decode:
                done = torch.ones((self.slots,), dtype=torch.bool)
                done[active] = False
                tok = sampling.greedy_masked(logits, done).cpu().numpy()
                cur_tok = tok.astype(np.int32)
                for si in active:
                    emit(si, int(tok[si]))
            ev.step_s = time.perf_counter() - t_step

            if stream is not None and stream.remaining == 0:
                # the last chunk's final position IS the last prompt token: its
                # logits seed the first token; the loop head places the request
                self._require(pre_logits is not None,
                              "admission stream drained without prefill logits")
                r = stream.req
                first = int(sampling.greedy(pre_logits[:, -1:, :])[0])
                ready = _Ready(r, stream.cache, first, stream.reused,
                               prompt=[int(t) for t in stream.toks[0]],
                               ctx=int(stream.toks.shape[1]))
                stream = None

        pool.release_staging()  # no handle outlives a serve()
        for r in range(n):  # terminal contract: nothing is left in flight
            if results[r].state not in TERMINAL_STATES:
                results[r].state = RequestState.FAILED
                results[r].finish_reason = FINISH_FAILED
                results[r].error = results[r].error or "engine exited with request non-terminal"
                results[r].finish_step = self._clock
        del self._reqs, self._eos
        self.last_results = results
        return results

    def _take_reuse(self) -> int:
        r, self._pending_reuse = self._pending_reuse, 0
        return r

    # ------------------------------------------------------- admission paths

    def _admit_batch(self, queue, cur_tok, emit) -> bool:
        """Fill free lanes with one admission pass when nothing is decoding.

        The JAX engine runs one ragged ``M.prefill`` per group here; the port
        prefills each taken request through a staging stream in
        ``chunk``-token sub-steps of the batch-prefill form (float GEMMs,
        dense attention), so a token's arithmetic is the same however
        requests are grouped. Groups and their events follow the JAX engine:
        one group, unless the pool's states cannot ride a right-padded ragged
        batch (recurrent state) and the lengths differ — then one group per
        request. Requests whose prompt hits the prefix store are not taken —
        they admit through the chunk stream, which maps the shared blocks."""
        reqs, results, pool = self._reqs, self._results, self.pool
        free = pool.free_slots()
        ext = {r: list(reqs[r].prompt) + results[r].tokens for r in queue}
        take: list[int] = []
        while queue and len(take) < len(free):
            if pool.peek_prefix(ext[queue[0]]) > 0:
                break
            take.append(queue.pop(0))
        if not take:
            return False
        lens = [len(ext[r]) for r in take]
        groups = ([[r] for r in take]
                  if not pool.policy.ragged_batch_ok and len(set(lens)) > 1 else [take])
        for group in groups:
            for r in group:
                results[r].state = RequestState.ADMITTED
                if results[r].admit_step is None:
                    results[r].admit_step = self._clock
            t_step = time.perf_counter()
            staged = []
            for r in group:
                toks = self._tokens([ext[r]])
                cache = pool.staging_step_prep(pool.begin_batch_admission(), len(ext[r]))
                logits, cache = interleave.prefill_chunk_step(
                    self.serving.params, cache, toks, self.cfg, sub_chunk=self.chunk,
                    gemm=True)
                if self.nan_guard and not _finite(None, [], logits):
                    raise KernelFault("decode_attention", "non-finite prefill logits")
                staged.append((r, cache, pool.park_staging(),
                               int(sampling.greedy(logits[:, -1:, :])[0])))
            glens = [len(ext[r]) for r in group]
            self._push_event(ScheduleEvent(plan_step(self.mode, False, True, sum(glens)),
                                           0, sum(glens),
                                           step_s=time.perf_counter() - t_step))
            for r, cache, handle, first in staged:
                si = pool.alloc(reqs[r], r, ctx=len(ext[r]), emitted=len(results[r].tokens))
                pool.insert(si, cache, prompt=ext[r], handle=handle)
                results[r].state = RequestState.RUNNING
                cur_tok[si] = first
                emit(si, first)
        return True

    # ------------------------------------------------------------- reporting

    def schedule_report(self) -> ScheduleReport:
        self._require(self.pool is not None, "schedule_report() without a pool")
        decode_events = [e for e in self.events if e.plan.decode]
        mode_steps: dict[str, int] = {}
        for e in self.events:
            mode_steps[e.mode] = mode_steps.get(e.mode, 0) + 1
        return ScheduleReport({
            "steps": len(self.events),
            "fused_steps": sum(1 for e in self.events if e.plan.fused),
            "modes": {e.plan.label for e in self.events},
            "mode_steps": mode_steps,
            "decode_steps": len(decode_events),
            "decode_slot_steps": sum(e.decode_batch for e in decode_events),
            "idle_slot_steps": sum(self.slots - e.decode_batch for e in decode_events),
            "prefill_tokens": sum(e.prefill_tokens for e in self.events),
            "reused_prefix_tokens": sum(e.reused_tokens for e in self.events),
            "arrivals": sum(e.arrivals for e in self.events),
            "prefix": self.pool.prefix_report(),
        })
