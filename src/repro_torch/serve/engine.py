"""Inference engine: slot-level continuous batching with BLOCKED/HBCEM/LBIM
(port of ``repro.serve.engine``).

``Engine.serve(requests)`` takes ``GenerationRequest`` objects and returns
index-aligned ``GenerationResult`` objects. The decode cache is a
:class:`~repro_torch.serve.cache.CachePool` (fully paged for the dense, vlm
and MoE families, contiguous lanes for the hybrid, for rwkv6's recurrent
state, for a windowed gemma2's rings or with ``paged=False``); the head of
the queue is chunk-prefilled ahead into a staging stream (a ring pool, which
cannot chunk, prefills it whole in one step) and dropped into the next freed
lane:

* **LBIM**    — the admission chunk rides in the same step as the decode
  (``core.interleave.fused_step``; the paper's MACT_LDB/MACB_LDT split);
* **HBCEM**   — decode at full internal bandwidth, then the admission chunk
  as a separate step half;
* **BLOCKED** — admission preempts: decodes stall until the pending request
  is fully loaded.

A recurrent request (zamba2, rwkv6) is staged in ``chunk``-token sub-steps
of its own where the JAX engine runs one ``M.prefill`` over an equal-length
group: its state moves forward a token at a time either way, so the tokens
are the same. The audio family is not served: admission has no source
frames, so its first admission raises, as the JAX engine's does.

Prefix reuse, per-request ``max_new_tokens``/``eos_id`` retirement, the
starvation-aware admission quantum, ``RequestState`` transitions and the
``ScheduleEvent`` stream follow the JAX engine exactly, so both engines give
the same tokens, states and events for the same requests. Sampling draws on
per-request RNG lanes whose keys are the JAX package's (``serve.sampling``),
so sampled tokens match too.

On the card every step program (the decode, the admission chunk, LBIM's
fused step, and a chunkable batch admission's sub-chunks) runs as a captured
CUDA graph from ``Engine.graphs`` (``core.interleave.StepGraphs``, freed with
the engine): the pool hands each step the same device tensors, refreshed in
place from its host state, and the tokens go to the graph from host memory.
The pool's sampling step (``sample_masked``, or ``greedy_masked`` when every
lane is greedy) is a program of the same object, its per-lane inputs copied
into static device buffers, and a speculative draft's catch-up and chained
feeds replay the engine's ``decode_only_step`` graphs on the draft's
persistent working lane. A capture that fails raises out of
:meth:`Engine.serve`. Left eager: ``models.model.prefill`` (MoE groups, ring
admission; op by op in the JAX package too), the draft's lane-resync
prefill (op by op in the JAX package too) and an admission's first-token
sampling (once per admitted request, over logits of any origin).

Speculative decoding (``spec=SpecConfig(draft, k)``, :mod:`serve.spec`)
drafts on a contiguous mirror pool and verifies every span position through
the same ``(slots, 1)`` decode program plain decode runs, over forked
block-table rows; its tokens equal the non-spec engine's at every
temperature.

The traffic plane and robustness follow the JAX engine path for path:
requests arrive at ``arrival_step`` on the engine-step clock (idle gaps jump
the clock in one event); ``ttft_deadline``/``deadline`` (steps from arrival)
and :meth:`Engine.cancel` are enforced at step boundaries; lane pressure and
a parked higher-priority admission preempt the lowest-priority running lane,
which requeues with its emitted tokens and resumes bit-identically; a
``step_policy`` chooses the mode (and whether speculation runs) per step; a
``fault_plan`` injects seeded faults. A failed step (a kernel error, an
injected ``kernel_exc``, a NaN trip or any other exception) restores its
verify forks. The port's ladder has one rung per op (``core.dispatch``), so
there is nothing to retry on: the step's participants fail with a typed
error while queued and parked requests go on being served, and
:meth:`Engine.health` counts the event. As in the JAX engine, batch admission
has no NaN guard of its own: a first token drawn there from non-finite
prefill logits is emitted, and the request fails at the next step's guard.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import interleave
from repro_torch.core.dispatch import DegradationLadder
from repro_torch.core.pim_modes import (Mode, StepChoice, StepPlan, StepPolicy, StepSignals,
                                        plan_step)
from repro_torch.device import tensor_device
from repro_torch.models import model as M
from repro_torch.serve import prng, sampling
from repro_torch.serve.api import (FINISH_CANCELLED, FINISH_EOS, FINISH_FAILED,
                                   FINISH_LENGTH, FINISH_TIMEOUT, TERMINAL_STATES,
                                   GenerationRequest, GenerationResult, RequestState)
from repro_torch.serve.cache import ACTIVE, CachePool
from repro_torch.serve.errors import EngineStateError, KernelFault, PoolExhausted
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.serving_model import ServingModel
from repro_torch.serve.spec import SpecConfig, SpecDecoder


@dataclass
class ScheduleEvent:
    """One engine step: the JAX engine's event fields, plus the port's
    ``clock``, ``failed``, ``step_s`` and its finer spec counters. The JAX
    engine's ``attempts`` and ``degraded`` are always 1 and False here (the
    port's ladder has one rung, so a step runs once), and are left out:
    ``pimsim.replay_events`` reads both with those defaults, so the port's
    events price as the JAX engine's do at its floor. The replay does not
    read ``failed``, as the JAX replay reads no such field."""
    plan: StepPlan
    decode_batch: int       # active decode lanes this step
    prefill_tokens: int     # admission-prefill tokens consumed this step
    decode_ctx: int = 0     # max context (cache fill) among active lanes
    reused_tokens: int = 0  # prompt tokens served from the prefix store
    slow_penalty: int = 0   # injected slow-step clock penalty (engine steps)
    kv_splits: int = 1      # paged decode KV-split fan-out
    mode: str = ""          # governing Mode this step (step-policy choice)
    arrivals: int = 0       # requests that became visible at this boundary
    queue_depth: int = 0    # arrived-but-unadmitted requests after arrivals
    emitted_tokens: int = 0  # tokens emitted at this event's boundary
    first_tokens: int = 0    # requests whose FIRST token emitted here
    idle_steps: int = 0      # pure-idle clock jump to the next arrival (idle
    #                          events advance the clock by this gap instead of
    #                          1 + slow_penalty)
    clock: int = 0           # engine-step clock the event began at (the step
    #                          a fault plan's entries are due against)
    failed: bool = False     # the step failed: its participants are FAILED
    step_s: float = 0.0      # host seconds from the step's launch to its tokens
    #                          on the host (the step ends in a device sync)
    # --- speculative decoding (plan.spec steps; all 0 otherwise) ----------
    spec_drafted: int = 0         # draft tokens proposed this round
    spec_accepted: int = 0        # draft tokens accepted this round
    spec_draft_steps: int = 0     # chained single-token draft feeds
    spec_rollouts: int = 0        # lanes that rolled out draft candidates
    spec_catchup_decodes: int = 0  # rollouts whose catch-up fed one token (a decode step)
    verify_tokens: int = 0        # target positions scored: lanes x (K+1)
    spec_max_emitted: int = 0     # most tokens any one lane emitted
    draft_prefill_tokens: int = 0  # draft-lane (re)sync prefill and catch-up tokens


class ScheduleReport(dict):
    """``schedule_report()``'s dict plus a JSON-safe export."""

    def to_json(self) -> dict:
        out = dict(self)
        out["modes"] = sorted(out["modes"])
        return out


def _finite(logits, active, pre_logits) -> bool:
    """NaN/Inf logit guard over positions that can become tokens: ACTIVE
    decode lanes and the admission chunk's final position. One host sync:
    every lane's verdict and the chunk's come back in one copy."""
    parts = []
    if logits is not None and active:
        parts.append(torch.isfinite(logits).flatten(1).all(1))
    if pre_logits is not None:
        parts.append(torch.isfinite(pre_logits[:, -1:, :]).all().reshape(1))
    if not parts:
        return True
    ok = torch.cat(parts).cpu()
    if pre_logits is not None and not bool(ok[-1]):
        return False
    return not (logits is not None and active) or bool(ok[active].all())


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
    # --- robustness knobs -------------------------------------------------
    fault_plan: Optional[FaultPlan] = None  # deterministic chaos injection
    nan_guard: bool = True                  # finite-logits check per step
    step_limit: Optional[int] = None        # watchdog; None -> sized from work
    spec: Optional[SpecConfig] = None       # draft/verify speculative decoding
    # --- traffic plane ----------------------------------------------------
    step_policy: Optional[StepPolicy] = None  # per-step mode choice; None ->
    #                                           the static `mode` pin governs
    spec_refill: bool = True  # scale the admission quantum with emitted tokens
    #                           (speculating lanes drain budgets up to (k+1)x
    #                            faster than retirements alone suggest)

    def __post_init__(self) -> None:
        if self.serving is None:
            self.serving = ServingModel.prepare(
                self.cfg, self.params, max_len=self.max_len, slots=self.slots,
                device=tensor_device(self.params))
        self.cfg = self.serving.cfg
        self.params = self.serving.params
        self.max_len = self.serving.max_len
        if self.spec is not None:
            self.spec.validate()
        if self.pool is None:
            # prefix blocks align with the admission chunk so a reuse run's
            # chunk boundaries match a cold run's exactly; spec_slack buys each
            # lane room for a verify round's transient k+1 appends
            self.pool = self.serving.cache_pool(
                slots=self.slots, prefix_cache=self.prefix_cache, block_size=self.chunk,
                spec_slack=self.spec.k if self.spec is not None else 0)
        elif self.pool.n_slots != self.slots:
            raise ValueError(f"pool has {self.pool.n_slots} slots, engine expects {self.slots}")
        elif self.pool.prefix_cache and self.pool.block_size != self.chunk:
            raise ValueError(f"pool block_size={self.pool.block_size} must equal engine "
                             f"chunk={self.chunk} when prefix caching is on")
        self.prefix_cache = self.pool.prefix_cache
        # the captured step programs (a jax.jit cache's counterpart): owned by
        # the engine, freed with it; the draft's feeds and the pool's sampling
        # run through them too
        self.graphs = interleave.StepGraphs(self.serving.device)
        self._vlogits: Optional[torch.Tensor] = None   # verify logits (slots, k+1, V)
        self.spec_dec: Optional[SpecDecoder] = None
        if self.spec is not None:
            if not self.pool.paged:
                raise ValueError(
                    "speculative decoding requires a fully paged target pool (verify "
                    "branches fork/rollback block-table rows); this pool is contiguous")
            if self.pool.spec_slack < self.spec.k:
                raise ValueError(
                    f"pool spec_slack={self.pool.spec_slack} < spec.k={self.spec.k}: a "
                    f"verify round near max_len would overflow the lane's block grid")
            self.spec_dec = SpecDecoder(self.spec.draft, self.serving, slots=self.slots,
                                        max_len=self.max_len, k=self.spec.k,
                                        graphs=self.graphs)
        # health counters accumulate for the engine's lifetime
        self.ladder = DegradationLadder(self.cfg, self.serving.device)
        self._health = {"preemptions": 0, "timeouts": 0, "cancellations": 0,
                        "failures": 0, "retried_steps": 0, "injected_faults": 0}
        self._in_serve = False
        self._cancel: set = set()
        # the exception of the last failed step attempt: a failed step's
        # requests carry only the ladder's verdict, this keeps the cause
        self.last_step_error: Optional[str] = None
        self.last_results: Optional[list[GenerationResult]] = None
        self.last_requests: Optional[list[GenerationRequest]] = None
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
        ev.clock = self._clock
        self.events.append(ev)
        # an idle event jumps the clock straight to the next arrival; every
        # other event is one engine step plus any injected slow penalty
        self._clock += ev.idle_steps if ev.idle_steps else 1 + ev.slow_penalty
        self._last_ev = ev

    def _tokens(self, rows) -> torch.Tensor:
        """Host tokens: a step program copies them into its graph's static
        buffer (``core.interleave``)."""
        return torch.from_numpy(np.asarray(rows, np.int64))

    # ------------------------------------------------------------------ API

    def serve(self, requests: Sequence[GenerationRequest]) -> list[GenerationResult]:
        """Serve ``requests`` through the persistent decode pool.

        Each request decodes to its own ``max_new_tokens``, retires the step
        it emits its ``eos_id`` (the EOS token is included), samples on its
        private RNG lane, and streams through ``on_token`` if set. Results are
        index-aligned with ``requests``; on return every result is terminal,
        whatever faulted mid-run.

        Robustness semantics (README "Failure semantics"): deadlines (engine
        steps from each request's arrival) and :meth:`cancel` take effect at
        step boundaries; lane pressure preempts the lowest-priority running
        lane, which requeues with its emitted tokens and resumes
        bit-identically (re-prefill of prompt + emitted tokens on the same RNG
        lane); a failed step fails only its participants.
        """
        self._require(self.serving is not None and self.pool is not None,
                      "Engine not prepared: serving artifact / cache pool missing")
        reqs = list(requests)
        for r in reqs:
            r.validate(self.max_len)
        n = len(reqs)
        self._reqs = reqs
        self._eos = [r.eos_id if r.eos_id is not None else self.cfg.eos_id for r in reqs]
        self._base_keys = [sampling.request_key(r.sampling.seed, r.prompt) for r in reqs]
        results = [GenerationResult(prompt_len=len(r.prompt), arrival_step=r.arrival_step)
                   for r in reqs]
        self._results = results

        self.events.clear()
        pool = self.pool
        ladder = self.ladder
        H = self._health
        faults = self.fault_plan
        if faults is not None:
            for f in faults.faults:  # a plan replays identically per serve
                f.fired = False
        pool.reset()  # fresh lanes + slot table; the prefix store survives
        spec_dec = self.spec_dec
        if spec_dec is not None:
            spec_dec.reset()
        # the arrival plane: a request is invisible to admission (and to the
        # step policy's signals) until the clock reaches its arrival_step.
        # `pending` is arrival-ordered (ties by submission index); `queue`
        # holds only arrived requests.
        pending: list[int] = sorted(range(n), key=lambda r: (reqs[r].arrival_step, r))
        queue: list[int] = []
        cur_tok = np.zeros((self.slots,), np.int32)
        stream: Optional[_Prefill] = None
        ready: Optional[_Ready] = None
        self._pending_reuse = 0
        self._clock = 0
        self._arrived_unstamped = 0
        self._queue_depth = 0
        self._last_ev = None
        self._cancel.clear()
        self._in_serve = True
        iters = 0
        limit = self.step_limit if self.step_limit is not None else (
            64 + max((r.arrival_step for r in reqs), default=0)
            + 8 * sum(len(r.prompt) + r.max_new_tokens for r in reqs))

        def ext_prompt(r: int) -> list[int]:
            """Admission span: prompt + already-emitted tokens, so a preempted
            request resumes exactly where eviction cut it off."""
            return list(reqs[r].prompt) + results[r].tokens

        def emit(si: int, tok: int) -> None:
            """Record one token for slot ``si``; retire the lane when done.
            The token's timestamp is the boundary the step's event just
            advanced the clock to."""
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
            if spec_dec is not None:  # the draft mirror never outlives it
                spec_dec.retire_lane(si)

        def preempt(si: int) -> None:
            """Evict lane ``si`` under pressure: retire (pages released) and
            requeue at the head with the emitted tokens kept."""
            r = pool.get(si).req
            pool.retire(si)
            if spec_dec is not None:
                spec_dec.retire_lane(si)
            H["preemptions"] += 1
            results[r].preemptions += 1
            results[r].state = RequestState.QUEUED
            queue.insert(0, r)

        def alloc_guarded(rdy: _Ready) -> int:
            """``pool.alloc`` with injected exhaustion and preemption healing."""
            r = rdy.req
            injected = (faults is not None
                        and faults.take(self._clock, "alloc_fail") is not None)
            if injected:
                H["injected_faults"] += 1  # models fragmentation/contention
            else:
                try:
                    return pool.alloc(reqs[r], r, reused_tokens=rdy.reused, ctx=rdy.ctx,
                                      emitted=len(results[r].tokens))
                except PoolExhausted:
                    pass
            # exhausted (injected or real): preempt the lowest-priority active
            # lane the incoming request outranks or ties
            victims = sorted((pool.get(si).priority, si) for si in pool.active_slots()
                             if pool.get(si).priority <= reqs[r].priority)
            if not victims:
                return -1  # stays parked; retried next boundary
            preempt(victims[0][1])
            return pool.alloc(reqs[r], r, reused_tokens=rdy.reused, ctx=rdy.ctx,
                              emitted=len(results[r].tokens))

        def place(rdy: _Ready) -> bool:
            """Drop a fully prefilled request into a lane (False: parked)."""
            si = alloc_guarded(rdy)
            if si < 0:
                return False
            pool.insert(si, rdy.cache, prompt=rdy.prompt or None)
            results[rdy.req].reused_prefix_tokens += rdy.reused
            results[rdy.req].state = RequestState.RUNNING
            cur_tok[si] = rdy.first_tok
            emit(si, rdy.first_tok)
            return True

        def evict(r: int, state: RequestState, reason: str,
                  error: Optional[str] = None) -> None:
            """Force request ``r`` terminal wherever it currently lives."""
            nonlocal stream, ready
            if results[r].state in TERMINAL_STATES:
                return
            if r in queue:
                queue.remove(r)
            if stream is not None and stream.req == r:
                stream = None
                pool.release_staging()  # the stream's pages go back
            if ready is not None and ready.req == r:
                ready = None
                pool.release_staging()  # its un-inserted handle too
            for si in pool.active_slots():
                if pool.get(si).req == r:
                    pool.retire(si)
                    if spec_dec is not None:
                        spec_dec.retire_lane(si)
            results[r].state = state
            results[r].finish_reason = reason
            results[r].error = error
            results[r].finish_step = self._clock

        def sweep() -> None:
            """Step-boundary enforcement: cancellations, then deadlines
            (measured from each request's arrival step)."""
            for r in sorted(self._cancel):
                if results[r].state not in TERMINAL_STATES:
                    evict(r, RequestState.CANCELLED, FINISH_CANCELLED)
                    H["cancellations"] += 1
            self._cancel.clear()
            for r in range(n):
                if results[r].state in TERMINAL_STATES:
                    continue
                rq = reqs[r]
                arr = rq.arrival_step
                if (rq.ttft_deadline is not None and not results[r].tokens
                        and self._clock >= arr + rq.ttft_deadline):
                    evict(r, RequestState.TIMED_OUT, FINISH_TIMEOUT,
                          f"no first token by ttft_deadline={rq.ttft_deadline} steps "
                          f"after arrival {arr} (step {self._clock})")
                    H["timeouts"] += 1
                elif rq.deadline is not None and self._clock >= arr + rq.deadline:
                    evict(r, RequestState.TIMED_OUT, FINISH_TIMEOUT,
                          f"not finished by deadline={rq.deadline} steps after "
                          f"arrival {arr} (step {self._clock})")
                    H["timeouts"] += 1

        def admit_arrivals() -> None:
            """Move requests whose arrival step the clock has reached from the
            pending plane into the admission queue (arrival order)."""
            while pending and reqs[pending[0]].arrival_step <= self._clock:
                r = pending.pop(0)
                if results[r].state not in TERMINAL_STATES:
                    queue.append(r)
                    self._arrived_unstamped += 1

        def ttft_slack() -> Optional[int]:
            """Tightest TTFT slack among arrived first-token-less live requests
            that declare a ttft_deadline (None if none do)."""
            slacks = [reqs[r].arrival_step + reqs[r].ttft_deadline - self._clock
                      for r in range(n)
                      if reqs[r].ttft_deadline is not None
                      and reqs[r].arrival_step <= self._clock
                      and results[r].state not in TERMINAL_STATES
                      and results[r].first_token_step is None]
            return min(slacks) if slacks else None

        while queue or pending or stream is not None or ready is not None \
                or pool.has_work():
            iters += 1
            if iters > limit:
                for r in range(n):  # watchdog: nothing hangs, ever
                    if results[r].state not in TERMINAL_STATES:
                        evict(r, RequestState.FAILED, FINISH_FAILED,
                              f"watchdog: step limit {limit} exceeded")
                        H["failures"] += 1
                break
            admit_arrivals()
            sweep()
            self._queue_depth = len(queue)

            # -- nothing to run but arrivals still due: jump the clock to the
            # next arrival as ONE zero-work idle event
            if (not queue and stream is None and ready is None
                    and not pool.has_work() and pending):
                gap = reqs[pending[0]].arrival_step - self._clock
                self._require(gap > 0, "idle jump planned with a due arrival")
                self._push_event(ScheduleEvent(plan_step(self.mode, False, False, 0), 0, 0,
                                               idle_steps=gap))
                continue

            # -- a parked request takes the first freed lane
            if ready is not None and pool.free_slots():
                if place(ready):
                    ready = None
                continue

            # -- priority preemption: a parked admission outranking a running
            # lane evicts the lowest-priority strict underdog
            if ready is not None:
                victims = sorted((pool.get(si).priority, si) for si in pool.active_slots()
                                 if pool.get(si).priority < reqs[ready.req].priority)
                if victims:
                    preempt(victims[0][1])
                    continue

            active = pool.active_slots()
            if not (queue or stream is not None or ready is not None or active):
                break  # sweep() emptied the engine

            # -- drained pool, nothing staged: batch-prefill straight into lanes
            if not active and stream is None and ready is None and queue:
                if self._admit_batch(queue, cur_tok, emit):
                    continue

            # -- stage the next pending request (one admission in flight)
            if stream is None and ready is None and queue:
                r = queue.pop(0)
                self._queue_depth = len(queue)
                results[r].state = RequestState.ADMITTED
                if results[r].admit_step is None:   # first admission only: a
                    results[r].admit_step = self._clock  # requeue never re-counts
                p = ext_prompt(r)
                if not pool.policy.chunkable:
                    # ring configs: a W-slot ring is a decode-only structure and
                    # cannot ingest a chunk, so admission is one full batch-1
                    # prefill, a serialization point in every mode
                    ready = self._prefill_one(r)
                    continue
                staging, skip = pool.stage_admission(p)
                self._pending_reuse += skip
                stream = _Prefill(req=r, toks=np.asarray([p], np.int32), cache=staging,
                                  off=skip, reused=skip)

            # starvation-aware admission rate: each FREE lane is wasted decode
            # bandwidth, so the quantum grows with the number of empty lanes
            # (1x when the stream merely runs ahead of retirement, up to
            # `slots`x when the pool is starved); under speculation it also
            # follows the last decode event's emitted tokens per lane. Quanta
            # are whole multiples of `chunk` with at most one sub-chunk tail.
            c = 0
            if stream is not None:
                boost = max(1, len(pool.free_slots()))
                if (self.spec_refill and spec_dec is not None and self._last_ev is not None
                        and self._last_ev.decode_batch > 0):
                    e = self._last_ev
                    boost = max(boost, -(-e.emitted_tokens // e.decode_batch))
                if stream.remaining >= self.chunk:
                    c = self.chunk * min(boost, stream.remaining // self.chunk)
                else:
                    c = stream.remaining
            # -- per-step mode: the step policy (when installed) resolves
            # LBIM-vs-HBCEM and speculative participation from the live
            # signals; otherwise the static `mode` pin governs, speculation on.
            choice = StepChoice(self.mode)
            if self.step_policy is not None:
                choice = self.step_policy.choose(StepSignals(
                    clock=self._clock, active=len(active), free=len(pool.free_slots()),
                    queue_depth=len(queue), pending_arrivals=len(pending),
                    stream_remaining=stream.remaining if stream is not None else 0,
                    backlog_prefill_tokens=sum(len(ext_prompt(r)) for r in queue),
                    backlog_decode_tokens=sum(reqs[r].max_new_tokens - len(results[r].tokens)
                                              for r in queue),
                    min_ttft_slack=ttft_slack()))
            step_mode = choice.mode
            # speculative draft depth per lane: the engine-wide k, capped by the
            # request's own spec_k and by its remaining budget (a round emits at
            # most k+1 tokens). Computed before planning, so a round where
            # nothing drafts is a plain decode step. A policy that withholds
            # spec leaves it empty: draft lanes stay synced by note_emitted.
            spec_ks: dict[int, int] = {}
            if spec_dec is not None and choice.allow_spec:
                for si in active:
                    s = pool.get(si)
                    rk = reqs[s.req].spec_k
                    k_eff = min(self.spec.k if rk is None else rk, self.spec.k,
                                s.budget - s.emitted - 1)
                    if k_eff > 0:
                        spec_ks[si] = k_eff
            plan = plan_step(step_mode, bool(active), stream is not None, c,
                             spec=bool(spec_ks))
            if stream is not None and c > 0:
                stream.cache = pool.staging_step_prep(stream.cache, c)

            # ---- guarded step execution: on an exception or a NaN trip the
            # attempt's forks are restored and the step fails (below). The
            # port's ladder has one rung per op, so there is nothing to retry
            # on: the JAX engine at its reference floor does the same.
            t_step = time.perf_counter()
            out = None
            if plan.spec:
                spec_dec.begin_round()
            try:
                out = self._run_step(plan, active, stream, c, cur_tok, spec_ks)
            except (EngineStateError, interleave.CaptureError):
                raise
            except Exception as e:  # noqa: BLE001 — the failure path IS the handler
                self.last_step_error = f"{type(e).__name__}: {e}"
                H["retried_steps"] += 1
                if isinstance(e, KernelFault):
                    ladder.record_fault(e.op)
            logits, new_cache, pre_logits, new_scache, drafts, forks, pos_before = \
                out if out is not None else (None,) * 5 + ({}, {})
            span = self._span   # the last attempt's verify span

            slow = 0
            if faults is not None:
                f = faults.take(self._clock, "slow_step")
                if f is not None:
                    H["injected_faults"] += 1
                    slow = f.penalty
            ev = ScheduleEvent(
                plan, len(active), c if plan.prefill_chunk else 0,
                max((pool.get(i).ctx for i in active), default=0),
                self._take_reuse(), slow_penalty=slow, mode=step_mode.value,
                failed=out is None,
                # a spec step is priced as one weights-resident verify pass,
                # not K+1 split-KV sweeps, so it does not fan out
                kv_splits=(max(1, self.cfg.decode_kv_splits)
                           if plan.decode and pool.paged and not plan.spec else 1))
            if plan.spec:
                st = spec_dec.round_stats()
                ev.spec_drafted = st["drafted"]
                ev.spec_draft_steps = st["draft_steps"]
                ev.spec_rollouts = st["rollouts"]
                ev.spec_catchup_decodes = st["catchup_decodes"]
                ev.draft_prefill_tokens = st["draft_prefill_tokens"]
                ev.verify_tokens = len(active) * span
            self._push_event(ev)

            if out is None:
                # fail ONLY the step's participants; parked/queued requests and
                # the engine itself keep serving. The attempt already restored
                # its verify forks; the lanes retire with their pages, so every
                # page is released exactly once.
                if spec_dec is not None:
                    spec_dec.abort_round()
                H["failures"] += 1
                err = "step failed after 1 attempts (degradation ladder exhausted)"
                for si in list(pool.active_slots()):
                    r = pool.get(si).req
                    pool.retire(si)
                    if spec_dec is not None:
                        spec_dec.retire_lane(si)
                    results[r].state = RequestState.FAILED
                    results[r].finish_reason = FINISH_FAILED
                    results[r].error = err
                    results[r].finish_step = self._clock
                if stream is not None:
                    results[stream.req].state = RequestState.FAILED
                    results[stream.req].finish_reason = FINISH_FAILED
                    results[stream.req].error = err
                    results[stream.req].finish_step = self._clock
                    stream = None
                    pool.release_staging()
                ev.step_s = time.perf_counter() - t_step
                continue

            if new_cache is not None:
                pool.commit(new_cache)
            if new_scache is not None:
                self._require(stream is not None, "stream vanished mid-step")
                stream.cache = new_scache
                stream.off += c

            if plan.spec:
                cur_tok = self._spec_accept(logits, active, drafts, forks, pos_before,
                                            cur_tok, ev, emit)
            elif plan.decode:
                tok = self._sample_slots(logits, active)
                cur_tok = tok.astype(np.int32)
                for si in active:
                    emit(si, int(tok[si]))
                    if spec_dec is not None:
                        # keep draft lanes in sync across plain decode steps
                        spec_dec.note_emitted(si, [int(tok[si])])
            ev.step_s = time.perf_counter() - t_step

            if stream is not None and stream.remaining == 0:
                # the last chunk's final position IS the last prompt token: its
                # logits seed the first token; the loop head places the request
                self._require(pre_logits is not None,
                              "admission stream drained without prefill logits")
                r = stream.req
                first = self._first_tokens(pre_logits[:, -1:, :], [r],
                                           offsets=[len(results[r].tokens)])[0]
                ready = _Ready(r, stream.cache, first, stream.reused,
                               prompt=[int(t) for t in stream.toks[0]],
                               ctx=int(stream.toks.shape[1]))
                stream = None

        self._in_serve = False
        pool.release_staging()  # no handle outlives a serve()
        for r in range(n):  # terminal contract: nothing is left in flight
            if results[r].state not in TERMINAL_STATES:
                results[r].state = RequestState.FAILED
                results[r].finish_reason = FINISH_FAILED
                results[r].error = results[r].error or "engine exited with request non-terminal"
                results[r].finish_step = self._clock
                H["failures"] += 1
        self.last_requests = reqs
        del self._reqs, self._eos, self._base_keys
        self.last_results = results
        return results

    def cancel(self, request_index: int) -> None:
        """Cancel an in-flight request (index into the ``serve()`` request
        list). Valid only while ``serve()`` runs — from an ``on_token``
        callback or another thread; it takes effect at the next step boundary
        and keeps the tokens already emitted."""
        if not self._in_serve:
            raise EngineStateError(
                "cancel() is only valid while serve() is running — request "
                "indices are scoped to the in-flight call")
        if not 0 <= request_index < len(self._reqs):
            raise EngineStateError(
                f"cancel({request_index}): no such request in the in-flight "
                f"serve ({len(self._reqs)} requests)")
        self._cancel.add(request_index)

    def _run_step(self, plan, active, stream, c, cur_tok, spec_ks):
        """One attempt at a step: an injected ``kernel_exc`` first (before any
        launch), then the draft rollouts and verify forks of a spec round, the
        decode and/or admission chunk, the verify positions and the NaN
        guard. The decode pool's writes are
        committed here only for verify positions (each before the next); the
        caller commits the rest; ``self._span`` is the attempt's verify span.
        On any exception the attempt's forks are restored (rows and refcounts
        bit-identical to the round's start) before it propagates to the
        caller."""
        pool, spec_dec, reqs = self.pool, self.spec_dec, self._reqs
        ladder, faults = self.ladder, self.fault_plan
        dparams = self.serving.decode_params
        graphs = self.graphs
        logits = pre_logits = new_cache = new_scache = None
        drafts: dict[int, list[int]] = {}
        forks: dict = {}
        pos_before: dict[int, int] = {}
        self._span = 1
        cfg = self.cfg
        try:
            if faults is not None:
                f = faults.take(self._clock, "kernel_exc",
                                pred=lambda f: ladder.kernel_live(f.op))
                if f is not None:
                    self._health["injected_faults"] += 1
                    raise KernelFault(f.op, injected=True)
            if plan.spec:
                # draft rollouts write into the draft decoder's working lane and
                # anchors: the draft pool changes only in finish_round, so a
                # retried attempt simply re-drafts
                spec_dec.prune({si: pool.get(si).req for si in active})
                dcfg = spec_dec.draft_cfg
                for si, k_eff in spec_ks.items():
                    s = pool.get(si)
                    spec_dec.ensure_lane(si, s.req, reqs[s.req],
                                         list(reqs[s.req].prompt) + self._results[s.req].tokens,
                                         dcfg)
                    drafts[si] = spec_dec.rollout(si, k_eff, dcfg)
                self._span = 1 + max(len(d) for d in drafts.values())
                forks = {si: pool.fork_lane(si) for si in active}
                pos_before = {si: forks[si].pos for si in active}
            feed = self._tokens(cur_tok[:, None])
            if plan.fused:
                self._require(stream is not None,
                              "fused step planned without an admission stream in flight")
                chunk_toks = self._tokens(stream.toks[:, stream.off:stream.off + c])
                logits, new_cache, pre_logits, new_scache = interleave.fused_step(
                    dparams, pool.views(span=1), feed, stream.cache, chunk_toks, cfg,
                    sub_chunk=self.chunk, graphs=graphs)
            else:
                if plan.decode:
                    logits, new_cache = interleave.decode_only_step(
                        dparams, pool.views(span=1), feed, cfg, graphs=graphs)
                if plan.prefill_chunk:
                    self._require(stream is not None,
                                  "prefill chunk planned without an admission stream")
                    chunk_toks = self._tokens(stream.toks[:, stream.off:stream.off + c])
                    pre_logits, new_scache = interleave.prefill_chunk_step(
                        dparams, stream.cache, chunk_toks, cfg, sub_chunk=self.chunk,
                        graphs=graphs)
            if plan.spec and self._span > 1:
                # Verify scores every span position through the SAME (slots, 1)
                # decode program plain decode runs, each committed into the
                # forked rows before the next, so the verify logits and the
                # accepted tokens' KV are the non-spec path's bits. Its logits
                # are the graph's static output, which the next position's
                # replay overwrites: each is copied first, into the engine's
                # verify buffer (fixed addresses for the sampling program).
                vbuf = self._verify_logits(logits)
                vbuf[:, :1].copy_(logits)
                pool.commit(new_cache)
                new_cache = None
                for j in range(1, self._span):
                    feed_j = np.zeros((self.slots, 1), np.int32)
                    for si, d in drafts.items():
                        if j - 1 < len(d):
                            feed_j[si, 0] = d[j - 1]
                    lg_j, nc_j = interleave.decode_only_step(
                        dparams, pool.views(span=1), self._tokens(feed_j), cfg,
                        graphs=graphs)
                    pool.commit(nc_j)
                    vbuf[:, j:j + 1].copy_(lg_j)
                logits = vbuf[:, :self._span]
            if self.nan_guard and not _finite(logits, active, pre_logits):
                ladder.record_nan()
                raise KernelFault("decode_attention", "non-finite logits (NaN/Inf guard trip)")
        except Exception:
            for fk in forks.values():
                if fk.live:
                    pool.restore_lane(fk)
            raise
        return logits, new_cache, pre_logits, new_scache, drafts, forks, pos_before

    def _verify_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The verify round's (slots, k+1, V) logits buffer, allocated once
        like the decode step's logits and kept by the sampling program."""
        if self._vlogits is None:
            self._vlogits = torch.empty((self.slots, self.spec.k + 1, logits.shape[-1]),
                                        dtype=logits.dtype, device=logits.device)
            self.graphs.keep(self._vlogits)
        return self._vlogits

    def _take_reuse(self) -> int:
        r, self._pending_reuse = self._pending_reuse, 0
        return r

    # --------------------------------------------------------------- sampling

    def _sample_slots(self, logits, active, offsets: Optional[dict] = None) -> np.ndarray:
        """One pool-wide sampling step with per-slot params and keys.

        When every active lane is greedy this is one argmax
        (``greedy_masked``): no key is derived and no filter runs.
        ``offsets`` overrides each lane's key index (slot -> absolute
        emitted-token index; default the slot's ``emitted``): a verify round
        samples position ``j`` at ``emitted + j``, the key non-spec decode
        uses when it reaches that token. Both forms are the engine's sampling
        program (``StepGraphs.sample``): the per-lane inputs are built here on
        the host and copied into its static device buffers."""
        pool = self.pool
        done = torch.ones((self.slots,), dtype=torch.bool)
        done[active] = False
        if all(self._reqs[pool.get(si).req].sampling.temperature <= 0 for si in active):
            return self.graphs.sample(logits, done).cpu().numpy()
        temps = np.zeros((self.slots,), np.float32)
        tks = np.zeros((self.slots,), np.int64)
        tps = np.ones((self.slots,), np.float32)
        keys = torch.zeros((self.slots, 2), dtype=torch.int64)
        sampled = []
        for si in active:
            sp = self._reqs[pool.get(si).req].sampling
            temps[si], tks[si], tps[si] = sp.temperature, sp.top_k, sp.top_p
            if sp.temperature > 0:
                sampled.append(si)
        # one batched fold_in for every sampled lane's token key
        offs = [pool.get(si).emitted if offsets is None else offsets[si] for si in sampled]
        keys[sampled] = prng.fold_in(
            torch.stack([self._base_keys[pool.get(si).req] for si in sampled]),
            torch.tensor(offs, dtype=torch.int64))
        return self.graphs.sample(logits, done, keys, torch.from_numpy(temps),
                                  torch.from_numpy(tks), torch.from_numpy(tps)).cpu().numpy()

    def _spec_accept(self, logits, active, drafts, forks, pos_before, cur_tok,
                     ev: ScheduleEvent, emit) -> np.ndarray:
        """Token-matching acceptance for one verify round.

        Every position ``j`` of the (slots, K+1, V) verify logits is sampled on
        the request's own RNG lane at absolute index ``emitted + j``; draft
        token ``d_j`` is accepted iff it equals the target's sample at the
        position that fed it. Surviving lanes roll back to their pre-round
        fill plus what they emitted (the verify pass itself wrote the accepted
        tokens' KV); each fork is spent exactly once."""
        pool, spec_dec, results = self.pool, self.spec_dec, self._results
        span = logits.shape[1]
        emitted_at = {si: pool.get(si).emitted for si in active}
        samp = np.zeros((self.slots, span), np.int32)
        for j in range(span):
            samp[:, j] = self._sample_slots(logits[:, j:j + 1, :], active,
                                            offsets={si: emitted_at[si] + j for si in active})
        new_cur = cur_tok.copy()
        for si in active:
            d = drafts.get(si, [])
            a = 0
            while a < len(d) and int(d[a]) == int(samp[si, a]):
                a += 1
            r = pool.get(si).req
            emitted: list[int] = []
            for j in range(a + 1):
                emitted.append(int(samp[si, j]))
                emit(si, int(samp[si, j]))
                if pool.get(si).state != ACTIVE:
                    break  # eos/budget: exactly where non-spec would stop
            results[r].spec_proposed += len(d)
            results[r].spec_accepted += a
            ev.spec_accepted += a
            ev.spec_max_emitted = max(ev.spec_max_emitted, len(emitted))
            if pool.get(si).state == ACTIVE:
                pool.rollback_lane(si, pos_before[si] + len(emitted))
                new_cur[si] = emitted[-1]
                spec_dec.finish_round(si, emitted)
            else:
                # retire released the lane's pages; the fork still holds its own
                spec_dec.retire_lane(si)
            pool.drop_fork(forks[si])
        return new_cur

    def _first_tokens(self, logits, rids: list[int],
                      offsets: Optional[list[int]] = None) -> list[int]:
        """Each request's prefill-seeded first token from logits (g, 1, V),
        sampled at key index ``offsets`` (0 on first admission). Eager: once
        per admission, over logits from any admission path."""
        g = len(rids)
        offs = offsets if offsets is not None else [0] * g
        sps = [self._reqs[r].sampling for r in rids]
        if all(sp.temperature <= 0 for sp in sps):
            return [int(t) for t in sampling.greedy(logits).cpu()]
        keys = torch.stack([
            sampling.token_key(self._base_keys[r], off) if sp.temperature > 0
            else torch.zeros((2,), dtype=torch.int64)
            for r, sp, off in zip(rids, sps, offs)])
        tok = sampling.sample_masked(
            logits, torch.zeros((g,), dtype=torch.bool), keys=keys,
            temperature=torch.tensor([sp.temperature for sp in sps], dtype=torch.float32),
            top_k=torch.tensor([sp.top_k for sp in sps], dtype=torch.int64),
            top_p=torch.tensor([sp.top_p for sp in sps], dtype=torch.float32))
        return [int(t) for t in tok.cpu()]

    # ------------------------------------------------------- admission paths

    def _full_prefill(self, prompts: list) -> tuple[torch.Tensor, dict]:
        """Whole spans through one ``M.prefill`` (float params), right-padded
        with token 0 to the longest as the JAX engine pads a group: each
        span's last-token logits (g, 1, V) and a contiguous cache with its
        fills ``pos`` (g,)."""
        lens = [len(p) for p in prompts]
        toks = np.zeros((len(prompts), max(lens)), np.int32)
        for j, p in enumerate(prompts):
            toks[j, :lens[j]] = p
        dev = self.serving.device
        seq_lens = self._tokens(lens).to(dev)
        logits, cache = M.prefill(self.serving.params, self._tokens(toks).to(dev), self.cfg,
                                  self.max_len, seq_lens=seq_lens if len(set(lens)) > 1 else None)
        cache["pos"] = seq_lens
        return logits, cache

    def _prefill_one(self, r: int) -> _Ready:
        """Full batch-1 prefill of request ``r`` -> a parked ``_Ready`` (the
        admission of a pool that cannot chunk). The span is prompt +
        already-emitted tokens, so a preempted ring request resumes through
        the path it was admitted by."""
        p = list(self._reqs[r].prompt) + self._results[r].tokens
        t_step = time.perf_counter()
        logits, cache = self._full_prefill([p])
        self._push_event(ScheduleEvent(plan_step(self.mode, False, True, len(p)), 0, len(p),
                                       step_s=time.perf_counter() - t_step))
        first = self._first_tokens(logits, [r], offsets=[len(self._results[r].tokens)])[0]
        return _Ready(r, cache, first, prompt=p, ctx=len(p))

    def _admit_batch(self, queue, cur_tok, emit) -> bool:
        """Fill free lanes with one admission pass when nothing is decoding.

        The JAX engine runs one ragged ``M.prefill`` per group here; the port
        prefills each taken request through a staging stream in
        ``chunk``-token sub-steps of the batch-prefill form (float GEMMs,
        dense attention), or, where the pool cannot chunk (rings), through
        its own ``M.prefill``, so a token's arithmetic is the same however
        requests are grouped. A token-coupled config (MoE: which picks drop
        depends on the tokens of the call) runs the JAX form itself: one
        ragged ``M.prefill`` per group, right-padded with token 0 to the
        group's longest, whose lanes the pool cuts into pages at insert.
        Groups and their events follow the JAX engine:
        one group, unless the pool's states cannot ride a right-padded ragged
        batch (recurrent state, rings) and the lengths differ — then one
        group per request. Requests whose prompt hits the prefix store are
        not taken — they admit through the chunk stream, which maps the
        shared blocks.
        Returns False when no request was admissible here (an injected
        ``alloc_fail`` included: the queue head then admits through the chunk
        stream, the engine's recovery route)."""
        reqs, results, pool = self._reqs, self._results, self.pool
        if (self.fault_plan is not None
                and self.fault_plan.take(self._clock, "alloc_fail") is not None):
            self._health["injected_faults"] += 1
            return False
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
            glens = [len(ext[r]) for r in group]
            staged = []   # (request, prefilled cache, its lane there, staging handle, first)
            if self.cfg.token_coupled:
                logits, cache = self._full_prefill([ext[r] for r in group])
                first = self._first_tokens(logits, group,
                                           offsets=[len(results[r].tokens) for r in group])
                staged = [(r, cache, j, None, first[j]) for j, r in enumerate(group)]
            else:
                for j, r in enumerate(group):
                    if pool.policy.chunkable:
                        toks = self._tokens([ext[r]])
                        cache = pool.staging_step_prep(pool.begin_batch_admission(j),
                                                       len(ext[r]))
                        logits, cache = interleave.prefill_chunk_step(
                            self.serving.params, cache, toks, self.cfg, sub_chunk=self.chunk,
                            gemm=True, graphs=self.graphs)
                    else:
                        logits, cache = self._full_prefill([ext[r]])
                    staged.append((r, cache, 0, pool.park_staging(),
                                   self._first_tokens(logits[:, -1:, :], [r],
                                                      offsets=[len(results[r].tokens)])[0]))
            self._push_event(ScheduleEvent(plan_step(self.mode, False, True, sum(glens)),
                                           0, sum(glens),
                                           step_s=time.perf_counter() - t_step))
            for r, cache, lane, handle, first in staged:
                si = pool.alloc(reqs[r], r, ctx=len(ext[r]), emitted=len(results[r].tokens))
                pool.insert(si, cache, prompt=ext[r], handle=handle, src_slot=lane)
                results[r].state = RequestState.RUNNING
                cur_tok[si] = first
                emit(si, first)
        return True

    # ------------------------------------------------------------- reporting

    def health(self) -> dict:
        """Engine health snapshot: the ladder's rungs and per-op fault
        counters, lifecycle counters (cumulative for the engine's lifetime),
        pool occupancy, and the fault plan's consumption state."""
        self._require(self.pool is not None, "health() without a pool")
        return {
            "degraded": False,   # one rung per op: nothing to degrade to
            "ladder": self.ladder.health(),
            "counters": dict(self._health),
            "occupancy": self.pool.occupancy().to_json(),
            "fault_plan": self.fault_plan.to_json() if self.fault_plan is not None else None,
        }

    def schedule_report(self) -> ScheduleReport:
        self._require(self.pool is not None, "schedule_report() without a pool")
        from repro_torch.serve.traffic import latency_summary  # cycle-free (lazy)
        decode_events = [e for e in self.events if e.plan.decode]
        mode_steps: dict[str, int] = {}
        for e in self.events:
            if e.idle_steps:
                continue  # idle jumps are clock bookkeeping, not mode picks
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
            "idle_steps": sum(e.idle_steps for e in self.events),
            "prefix": self.pool.prefix_report(),
            "retried_step_attempts": 0,   # a step runs once (one rung per op)
            "degraded_steps": 0,
            "slow_penalty_steps": sum(e.slow_penalty for e in self.events),
            "spec": self._spec_report(),
            "latency": latency_summary(self.last_results or [], self.last_requests),
            "health": self.health(),
        })

    def _spec_report(self) -> dict:
        """Speculative-decoding stats summed over the event stream."""
        spec_events = [e for e in self.events if e.plan.spec]
        proposed = sum(e.spec_drafted for e in spec_events)
        accepted = sum(e.spec_accepted for e in spec_events)
        return {
            "enabled": self.spec_dec is not None,
            "rounds": len(spec_events),
            "proposed": proposed,
            "accepted": accepted,
            "acceptance_rate": (accepted / proposed) if proposed else 0.0,
            "draft_steps": sum(e.spec_draft_steps for e in spec_events),
            "draft_prefill_tokens": sum(e.draft_prefill_tokens for e in spec_events),
            "verify_tokens": sum(e.verify_tokens for e in spec_events),
        }


def wave_baseline_report(prompt_lens: Sequence[int], max_news: Sequence[int],
                         slots: int) -> dict:
    """Decode-step accounting of the OLD wave engine for the same request set.

    Waves of ``slots`` requests in submission order; every wave decodes to its
    batch-max ``max_new`` (first token comes from prefill, so a wave costs
    ``max(max_new) - 1`` decode steps) and per-request budgets are enforced by
    truncation only. ``idle_slot_steps`` counts slot-steps that produce no
    kept token: empty lanes plus lanes decoding past their own budget.
    """
    decode_steps = slot_steps = idle = 0
    reqs = list(zip(prompt_lens, max_news))
    for w0 in range(0, len(reqs), slots):
        wave = reqs[w0: w0 + slots]
        steps_w = max(mn for _, mn in wave) - 1
        decode_steps += steps_w
        slot_steps += len(wave) * steps_w
        idle += (slots - len(wave)) * steps_w
        idle += sum(steps_w - (mn - 1) for _, mn in wave)
    return {"decode_steps": decode_steps, "decode_slot_steps": slot_steps,
            "idle_slot_steps": idle}


def wave_baseline_events(prompt_lens: Sequence[int], max_news: Sequence[int],
                         slots: int, mode: Mode = Mode.HBCEM) -> list:
    """The OLD wave engine's ``ScheduleEvent`` stream, so
    ``pimsim.replay_events`` can price the wave schedule against a continuous
    one. Every wave decodes its FULL width to the batch-max budget: the
    over-decoded slot-steps are the work continuous batching reclaims by
    retiring lanes mid-flight.
    """
    events = []
    reqs = list(zip(prompt_lens, max_news))
    for w0 in range(0, len(reqs), slots):
        wave = reqs[w0: w0 + slots]
        ptoks = sum(pl for pl, _ in wave)
        events.append(ScheduleEvent(plan_step(mode, False, True, ptoks), 0, ptoks))
        for t in range(max(mn for _, mn in wave) - 1):
            ctx = max(pl + 1 + t for pl, _ in wave)
            events.append(ScheduleEvent(plan_step(mode, True, False, 0),
                                        len(wave), 0, ctx))
    return events
