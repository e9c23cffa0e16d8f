"""Operating modes — the paper's Table II instruction set as scheduler policy.

The port's own copy of ``repro.core.pim_modes``: ``Mode``, ``StepPlan``,
``plan_step``, and the per-step policies (``StepSignals``, ``StepChoice``,
``StepPolicy``, ``StaticPolicy``, ``SloAwarePolicy``, ``resolve_policy``).

* **LBIM**    — decode + prefill chunk in one fused step (MACT_LDB / MACB_LDT).
* **HBCEM**   — decode at full internal bandwidth (PIM_MAC_FM), then the
  prefill chunk as a separate program in the same engine step ("split").
* **BLOCKED** — admission preempts: the prefill chunk runs alone and every
  active decode stalls until the pending request is fully loaded.

All three produce identical greedy tokens; they differ only in schedule.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional


class Mode(enum.Enum):
    BLOCKED = "blocked"   # prior PIM: serialize prefill and decode
    HBCEM = "hbcem"       # PIM_MAC_FM: decode at full internal bandwidth
    LBIM = "lbim"         # MACT_LDB/MACB_LDT: overlap decode with prefill


@dataclass(frozen=True)
class StepPlan:
    """What one engine step executes."""
    decode: bool            # run a decode step for active sequences
    prefill_chunk: int      # tokens of pending-request prefill in this step
    fused: bool             # both in ONE step (LBIM overlap)
    spec: bool = False      # the decode half is a draft/verify round

    @property
    def label(self) -> str:
        if self.decode and self.prefill_chunk:
            base = "MACT_LDB" if self.fused else "split"
            return base + "+VERIFY" if self.spec else base
        if self.decode:
            return "SPEC_VERIFY" if self.spec else "PIM_MAC_FM"
        return "LOAD" if self.prefill_chunk else "IDLE"


def plan_step(mode: Mode, have_decodes: bool, have_prefills: bool,
              chunk: int, spec: bool = False) -> StepPlan:
    """Resolve one continuous-batching engine step for ``mode``."""
    if have_decodes and have_prefills:
        if mode is Mode.LBIM:
            return StepPlan(decode=True, prefill_chunk=chunk, fused=True, spec=spec)
        if mode is Mode.HBCEM:
            return StepPlan(decode=True, prefill_chunk=chunk, fused=False, spec=spec)
        return StepPlan(decode=False, prefill_chunk=chunk, fused=False)
    if have_decodes:
        return StepPlan(decode=True, prefill_chunk=0, fused=False, spec=spec)
    return StepPlan(decode=False, prefill_chunk=chunk, fused=False)


# --------------------------------------------------------------- step policy
#
# Under arrival-driven traffic the LBIM-vs-HBCEM decision is a property of the
# step: whether admission work is in flight, how deep the arrived backlog is,
# and how much TTFT slack the tightest waiting request has. A ``StepPolicy``
# makes that call every engine step from a :class:`StepSignals` snapshot; the
# engine's static ``mode=`` pin is the degenerate :class:`StaticPolicy`.


@dataclass(frozen=True)
class StepSignals:
    """What the engine knows at a step boundary, all on the engine-step clock
    (no wall time, so decisions replay bit-identically). ``min_ttft_slack`` is
    the tightest ``arrival + ttft_deadline - clock`` over requests without a
    first token (None when none declares a TTFT deadline)."""

    clock: int                  # engine-step clock
    active: int                 # lanes decoding this step
    free: int                   # free lanes
    queue_depth: int            # arrived, not yet being admitted
    pending_arrivals: int       # submitted, arrival step still in the future
    stream_remaining: int       # prefill tokens left on the in-flight stream
    backlog_prefill_tokens: int  # prompt tokens waiting in the arrived queue
    backlog_decode_tokens: int   # budget tokens waiting in the arrived queue
    min_ttft_slack: Optional[int] = None


@dataclass(frozen=True)
class StepChoice:
    """One step's resolution: the Pbank mode, and whether speculative
    draft/verify rounds may run this step."""

    mode: Mode
    allow_spec: bool = True


class StepPolicy:
    """Per-step mode selection: subclasses override :meth:`choose`, which the
    engine calls once per planned step, before ``plan_step``."""

    name = "policy"

    def choose(self, sig: StepSignals) -> StepChoice:  # pragma: no cover
        raise NotImplementedError


@dataclass(frozen=True)
class StaticPolicy(StepPolicy):
    """The static pin, expressed as a policy."""

    mode: Mode

    @property
    def name(self) -> str:  # type: ignore[override]
        return self.mode.value

    def choose(self, sig: StepSignals) -> StepChoice:
        return StepChoice(self.mode)


@dataclass(frozen=True)
class SloAwarePolicy(StepPolicy):
    """SLO-aware auto mode: LBIM whenever an admission stream is in flight or
    arrived requests wait (overlap prefill with the running decodes), HBCEM
    when the pool is the only work. Speculation stretches the steps an
    admission needs to reach a waiting request's first token, so it is held
    back while admission work exists, unless the tightest TTFT slack exceeds
    ``slack_margin`` steps."""

    name = "auto"
    slack_margin: int = 0   # spec despite admission work iff slack > margin

    def choose(self, sig: StepSignals) -> StepChoice:
        admission_work = sig.stream_remaining > 0 or sig.queue_depth > 0
        mode = Mode.LBIM if admission_work else Mode.HBCEM
        if not admission_work:
            return StepChoice(mode, allow_spec=True)
        relaxed = (self.slack_margin > 0
                   and sig.min_ttft_slack is not None
                   and sig.min_ttft_slack > self.slack_margin)
        return StepChoice(mode, allow_spec=relaxed)


def resolve_policy(policy: "StepPolicy | Mode | str | None",
                   default_mode: Mode = Mode.HBCEM) -> StepPolicy:
    """Coerce a policy spec — a :class:`StepPolicy`, a :class:`Mode`, a mode
    string, ``"auto"``, or None — into a ``StepPolicy``."""
    if policy is None:
        return StaticPolicy(default_mode)
    if isinstance(policy, StepPolicy):
        return policy
    if isinstance(policy, Mode):
        return StaticPolicy(policy)
    if policy == "auto":
        return SloAwarePolicy()
    return StaticPolicy(Mode(policy))
