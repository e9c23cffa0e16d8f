"""Event-driven LBIM scheduler — paper Fig. 4(c).

LBIM timeline for a batch of R requests, all arriving at t=0:

* Processor prefills requests back-to-back (GEMM, reading DRAM through the
  two processor-side Pbanks via MACT_LDB / MACB_LDT).
* As soon as request i finishes prefill, its decode joins the PIM queue.
* While the processor is still prefilling, PIM runs with HALF its Pbanks
  (lbim rate); once the last prefill retires, the controller switches to
  PIM_MAC_FM and decode proceeds at the full HBCEM rate.
* Decode of one sequence is strictly autoregressive — parallelism across the
  batch only.

The simulator advances step-by-step over the set of decode-ready requests;
each step's latency reflects the current Pbank split and batch size.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.pimsim.device import DeviceSpec
from repro_torch.pimsim.latency import (
    StageBreakdown,
    gpu_prefill_time,
    pim_decode_step_time,
    verify_step_time,
)
from repro_torch.pimsim.llm import LLMSpec
from repro_torch.pimsim.pim import PIMDesign


@dataclass
class Request:
    lin: int
    lout: int
    generated: int = 0

    @property
    def done(self) -> bool:
        return self.generated >= self.lout

    @property
    def context(self) -> int:
        return self.lin + self.generated


@dataclass
class Trace:
    """Timeline segments for the Fig.4-style timing diagram benchmark."""
    events: list = field(default_factory=list)  # (t0, t1, resource, label)

    def add(self, t0, t1, resource, label):
        self.events.append((round(t0, 6), round(t1, 6), resource, label))


def lbim_e2e(model: LLMSpec, lin: int, lout: int, dev: DeviceSpec, design: PIMDesign,
             batch: int = 1, trace: Trace | None = None) -> StageBreakdown:
    reqs = [Request(lin, lout) for _ in range(batch)]
    p1 = gpu_prefill_time(model, lin, dev)
    prefill_done = [p1 * (i + 1) for i in range(batch)]
    all_prefill_done = prefill_done[-1]
    if trace is not None:
        for i, t in enumerate(prefill_done):
            trace.add(t - p1, t, "processor", f"prefill r{i}")

    t = prefill_done[0]  # first decode can start here
    decode_busy = 0.0
    while not all(r.done for r in reqs):
        ready = [r for i, r in enumerate(reqs) if not r.done and
                 prefill_done[i] <= t + 1e-12]
        if not ready:
            # PIM idle until the next prefill retires
            t = min(pd for r, pd in zip(reqs, prefill_done) if not r.done)
            continue
        lbim_phase = t < all_prefill_done - 1e-12
        ctx = max(r.context for r in ready)
        step = pim_decode_step_time(model, ctx, dev, design,
                                    batch=len(ready), lbim=lbim_phase)
        if trace is not None:
            trace.add(t, t + step, "pim",
                      f"decode x{len(ready)} ({'½' if lbim_phase else 'full'})")
        t += step
        decode_busy += step
        for r in ready:
            r.generated += 1

    total = t
    return StageBreakdown(prefill_s=all_prefill_done, decode_s=total - all_prefill_done)


@dataclass
class ReplayReport:
    """Timing-model price of an engine-produced per-step schedule."""
    total_s: float
    decode_busy_s: float
    prefill_busy_s: float
    overlap_saved_s: float  # serialized cost minus scheduled cost
    reused_prefill_tokens: int = 0  # prompt tokens served from the prefix store
    prefix_saved_s: float = 0.0     # processor prefill time those tokens skip
    degraded_steps: int = 0      # steps run below their base backend rung
    retried_attempts: int = 0    # extra (discarded) step attempts re-priced
    stall_s: float = 0.0         # retry re-execution + slow-step penalties
    # --- speculative decoding -------------------------------------------
    spec_rounds: int = 0         # draft/verify rounds priced
    spec_proposed: int = 0       # draft tokens proposed
    spec_accepted: int = 0       # draft tokens accepted
    spec_saved_s: float = 0.0    # plain-decode counterfactual minus spec cost
    #                              (SIGNED: negative when acceptance is poor)
    idle_steps: int = 0          # engine-clock steps skipped waiting on arrivals
    # per-event (clock_after, t_after) pairs on the simulated timeline —
    # the bridge from engine-step latency marks (arrival / first-token /
    # finish clocks) to simulated seconds; see ``clock_to_time``. Not part
    # of ``to_json()``.
    timeline: list = field(default_factory=list, repr=False)

    @property
    def serialized_s(self) -> float:
        return self.total_s + self.overlap_saved_s

    @property
    def acceptance_rate(self) -> float:
        return (self.spec_accepted / self.spec_proposed
                if self.spec_proposed else 0.0)

    def to_json(self) -> dict:
        """JSON-safe export (BENCH_serving.json tracks these across PRs).

        ``overlap_saved_s`` is a difference of accumulated float sums; when
        a schedule has no real overlap it can land at ~1e-17 instead of 0.0
        and churn the benchmark diff. Exact-zero is the honest export."""
        overlap = self.overlap_saved_s if abs(self.overlap_saved_s) >= 1e-9 else 0.0
        return {
            "total_s": self.total_s,
            "decode_busy_s": self.decode_busy_s,
            "prefill_busy_s": self.prefill_busy_s,
            "overlap_saved_s": overlap,
            "serialized_s": self.serialized_s,
            "reused_prefill_tokens": self.reused_prefill_tokens,
            "prefix_saved_s": self.prefix_saved_s,
            "degraded_steps": self.degraded_steps,
            "retried_attempts": self.retried_attempts,
            "stall_s": self.stall_s,
            "spec_rounds": self.spec_rounds,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "acceptance_rate": self.acceptance_rate,
            "spec_saved_s": self.spec_saved_s,
            "idle_steps": self.idle_steps,
        }


def clock_to_time(timeline, clock: int) -> float:
    """Simulated seconds at which the engine-step clock REACHED ``clock``.

    ``timeline`` is ``ReplayReport.timeline`` — monotone ``(clock_after,
    t_after)`` pairs, one per replayed event. Returns the end time of the
    first event whose post-event clock is >= ``clock`` (the earliest
    simulated instant the engine's clock stands at or past ``clock``);
    clock 0 is time 0, and clocks beyond the last event clamp to the end of
    the timeline. Engine latency marks are recorded as post-event clocks,
    so token marks map exactly; an arrival landing inside a multi-step
    event (slow-step stall) maps to that event's end — the first boundary
    at which the engine could have seen it.
    """
    if clock <= 0:
        return 0.0
    lo, hi = 0, len(timeline)
    while lo < hi:  # first index with timeline[i].clock_after >= clock
        mid = (lo + hi) // 2
        if timeline[mid][0] < clock:
            lo = mid + 1
        else:
            hi = mid
    if lo == len(timeline):
        return timeline[-1][1] if timeline else 0.0
    return timeline[lo][1]


def replay_events(events, model: LLMSpec, dev: DeviceSpec, design: PIMDesign,
                  draft_model: LLMSpec | None = None) -> ReplayReport:
    """Price a serving engine's ``ScheduleEvent`` stream with the calibrated
    timing model (the bridge from ``serve.engine.schedule_report()`` to
    simulated seconds on-device).

    Events are duck-typed: ``e.plan.decode`` / ``e.plan.fused``,
    ``e.decode_batch``, ``e.decode_ctx`` and ``e.prefill_tokens``. Per step:

    * decode half  — ``pim_decode_step_time`` at the step's live batch and
      max context; fused (MACT_LDB/MACB_LDT) steps run the CUs on HALF the
      Pbanks (``lbim=True``).
    * prefill half — the processor's GEMM over the admission chunk
      (``gpu_prefill_time``).
    * fused steps overlap the halves (``max``), with the controller falling
      back to serialized PIM_MAC_FM whenever overlap would lose — mirroring
      ``lbim_e2e``'s mode switch; split/blocked steps serialize (``+``).
    * prefix-index hits (``e.reused_tokens``) are prompt tokens the engine
      *mapped* instead of prefilled: they never enter any step's cost, and
      the report prices what they WOULD have cost as ``prefix_saved_s`` —
      the admission-time saving ``BENCH_serving.json`` tracks.
    * robustness events are priced HONESTLY: a step retried by the
      degradation ladder (``e.attempts > 1``) re-executes its work per
      attempt (discarded attempts are paid, not hidden), and injected slow
      steps (``e.slow_penalty``) stall the timeline by that many extra step
      times. Both accumulate into ``stall_s``; ``degraded_steps`` counts
      steps that ran below their base backend rung.
    * speculative rounds (``e.plan.spec``) price the draft rollout as PIM
      GEMV steps on ``draft_model`` (HBCEM batch-1; half-Pbank rate inside a
      fused step) and the batched k+1-position verify pass as a processor
      GEMM (``verify_step_time`` — weights stream ONCE for all positions).
      Draft-lane (re)sync prefills ride the processor. ``spec_saved_s`` is
      the SIGNED difference against the counterfactual of emitting the same
      tokens as plain decode steps — negative when acceptance is poor, which
      is the honest answer. ``draft_model=None`` self-drafts (prices the
      rollout on the target).
    """
    total = decode_busy = prefill_busy = 0.0
    reused = 0
    saved = stall = 0.0
    degraded_steps = retried = 0
    spec_rounds = spec_proposed = spec_accepted = 0
    spec_saved = 0.0
    idle_total = 0
    clock = 0
    timeline: list = []
    draft = model if draft_model is None else draft_model
    for e in events:
        r = getattr(e, "reused_tokens", 0)
        if r:
            reused += r
            saved += gpu_prefill_time(model, r, dev)
        p = gpu_prefill_time(model, e.prefill_tokens, dev) if e.prefill_tokens else 0.0
        is_spec = (e.plan.decode and e.decode_batch > 0
                   and getattr(e.plan, "spec", False))
        if is_spec:
            ctx = max(e.decode_ctx, 1)
            nv = max(getattr(e, "verify_tokens", 0), 1) // max(e.decode_batch, 1)
            t_verify = verify_step_time(model, nv, ctx, dev,
                                        batch=e.decode_batch)
            dsteps = max(getattr(e, "spec_draft_steps", 0), 0)
            t_dfull = dsteps * pim_decode_step_time(draft, ctx, dev, design,
                                                    batch=1, lbim=False)
            dpf = getattr(e, "draft_prefill_tokens", 0)
            t_dpf = gpu_prefill_time(draft, dpf, dev) if dpf else 0.0
            # drafting is PIM work; verify + admission prefill + draft sync
            # are processor work. Fused (MACT_LDB) overlaps drafting with
            # the processor chain at the half-Pbank rate; verify always
            # FOLLOWS drafting (it scores the drafted candidates).
            serial = t_dfull + t_dpf + p + t_verify
            if e.plan.fused:
                t_dhalf = dsteps * pim_decode_step_time(
                    draft, ctx, dev, design, batch=1, lbim=True)
                fused_cost = max(t_dhalf, t_dpf + p) + t_verify
                if fused_cost <= serial:
                    step, d = fused_cost, t_dhalf + t_verify
                else:
                    step, d = serial, t_dfull + t_verify
            else:
                step, d = serial, t_dfull + t_verify
            p_eff = p + t_dpf
            # counterfactual: the round's emitted tokens as plain decode
            # steps (the admission chunk rides the first one, as it would)
            m = max(getattr(e, "spec_max_emitted", 0), 1)
            bd = pim_decode_step_time(model, ctx, dev, design,
                                      batch=e.decode_batch, lbim=False)
            if e.plan.fused:
                bh = pim_decode_step_time(model, ctx, dev, design,
                                          batch=e.decode_batch, lbim=True)
                first = max(bh, p) if max(bh, p) <= bd + p else bd + p
            else:
                first = bd + p
            spec_saved += first + (m - 1) * bd - step
            spec_rounds += 1
            spec_proposed += getattr(e, "spec_drafted", 0)
            spec_accepted += getattr(e, "spec_accepted", 0)
        else:
            d_full = d_half = 0.0
            if e.plan.decode and e.decode_batch > 0:
                ctx = max(e.decode_ctx, 1)
                splits = max(getattr(e, "kv_splits", 1), 1)
                d_full = pim_decode_step_time(model, ctx, dev, design,
                                              batch=e.decode_batch, lbim=False,
                                              kv_splits=splits)
                if e.plan.fused:
                    d_half = pim_decode_step_time(model, ctx, dev, design,
                                                  batch=e.decode_batch,
                                                  lbim=True, kv_splits=splits)
            if e.plan.fused and max(d_half, p) <= d_full + p:
                step, d = max(d_half, p), d_half
            else:
                step, d = d_full + p, d_full
            p_eff = p
        attempts = max(getattr(e, "attempts", 1), 1)
        slow = max(getattr(e, "slow_penalty", 0), 0)
        waste = step * (attempts - 1) + step * slow
        total += step + waste
        stall += waste
        retried += attempts - 1
        degraded_steps += 1 if getattr(e, "degraded", False) else 0
        decode_busy += d * attempts
        prefill_busy += p_eff * attempts
        # engine-clock bookkeeping mirrors Engine._push_event exactly: an
        # idle event advances the clock by its arrival gap at zero simulated
        # cost (the device sits dark between arrivals — total_s stays busy
        # time), any other event by 1 + its slow penalty.
        idle = max(getattr(e, "idle_steps", 0), 0)
        clock += idle if idle else 1 + slow
        idle_total += idle
        timeline.append((clock, total))
    return ReplayReport(total_s=total, decode_busy_s=decode_busy,
                        prefill_busy_s=prefill_busy,
                        overlap_saved_s=max(decode_busy + prefill_busy - total, 0.0),
                        reused_prefill_tokens=reused, prefix_saved_s=saved,
                        degraded_steps=degraded_steps, retried_attempts=retried,
                        stall_s=stall, spec_rounds=spec_rounds,
                        spec_proposed=spec_proposed,
                        spec_accepted=spec_accepted, spec_saved_s=spec_saved,
                        idle_steps=idle_total, timeline=timeline)


def blocked_trace(model, lin, lout, dev, design, batch=1) -> Trace:
    """HBCEM (blocked) timeline for the Fig.4 diagram."""
    tr = Trace()
    p1 = gpu_prefill_time(model, lin, dev)
    t = 0.0
    for i in range(batch):
        tr.add(t, t + p1, "processor", f"prefill r{i}")
        t += p1
    for step_idx in range(lout):
        s = pim_decode_step_time(model, lin + step_idx, dev, design, batch=batch)
        tr.add(t, t + s, "pim", f"decode x{batch}")
        t += s
    return tr
