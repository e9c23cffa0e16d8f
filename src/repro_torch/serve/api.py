"""Request-level serving surface (the port's own copy of ``repro.serve.api``).

The types are the JAX package's, field for field: :class:`SamplingParams`,
:class:`GenerationRequest`, :class:`GenerationResult`, :class:`RequestState`
and the ``FINISH_*`` reasons. The port's engine serves all of them: greedy and
sampled requests, speculative depth caps, priorities, deadlines and arrival
steps.

Lifecycle: QUEUED -> ADMITTED -> RUNNING -> FINISHED (``finish_reason``
``"length"`` or ``"eos"``); FAILED / TIMED_OUT / CANCELLED are the other
terminal states; preemption sends a RUNNING request back to QUEUED with its
emitted tokens kept.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Optional

FINISH_LENGTH = "length"
FINISH_EOS = "eos"
FINISH_TIMEOUT = "timeout"
FINISH_CANCELLED = "cancelled"
FINISH_FAILED = "failed"


class RequestState(str, enum.Enum):
    """Typed request lifecycle (values are the JSON-safe wire strings)."""

    QUEUED = "queued"        # submitted, no admission work started
    ADMITTED = "admitted"    # being prefilled / parked for a lane
    RUNNING = "running"      # holds a decode lane
    FINISHED = "finished"    # emitted to budget or eos (terminal)
    FAILED = "failed"        # step failure survived the ladder (terminal)
    TIMED_OUT = "timed_out"  # ttft/total deadline passed (terminal)
    CANCELLED = "cancelled"  # cancel(request) honored (terminal)


TERMINAL_STATES = frozenset({
    RequestState.FINISHED, RequestState.FAILED,
    RequestState.TIMED_OUT, RequestState.CANCELLED,
})


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling policy. ``temperature=0`` (the default) is exact
    greedy argmax; ``top_k=0`` disables the k-cutoff; ``top_p=1.0`` disables
    the nucleus cutoff. ``seed`` seeds this request's private RNG lane."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def validate(self) -> None:
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


GREEDY = SamplingParams()


@dataclass
class GenerationRequest:
    """One serving request: admitted into a slot, decoded to its own budget.

    ``priority`` orders preemption only (admission stays FIFO): under pool
    pressure the lowest-priority RUNNING slot is evicted first, and a parked
    higher-priority admission may evict a strictly-lower-priority slot.
    ``ttft_deadline`` / ``deadline`` are engine-step budgets measured from
    ``serve()`` start and enforced at step boundaries: a request that has
    not emitted its first token by ``ttft_deadline`` steps, or not reached a
    terminal state by ``deadline`` steps, is TIMED_OUT (already-emitted
    tokens are kept).
    """

    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None          # None -> ModelConfig.eos_id
    sampling: SamplingParams = field(default_factory=SamplingParams)
    on_token: Optional[Callable[[int], None]] = None  # streaming callback
    priority: int = 0                     # higher preempts lower
    ttft_deadline: Optional[int] = None   # engine steps until first token
    deadline: Optional[int] = None        # engine steps until terminal
    spec_k: Optional[int] = None          # per-request draft depth cap
    arrival_step: int = 0                 # engine step the request arrives
    # ``arrival_step`` puts the request on the ARRIVAL-TIME plane: it stays
    # invisible to admission (and to the queue-depth signals a step policy
    # reads) until the engine-step clock reaches it, and both deadlines are
    # measured from it — ``ttft_deadline``/``deadline`` bound steps *since
    # arrival*, not since ``serve()`` started. The default 0 is the legacy
    # everything-arrives-up-front behaviour.
    # ``spec_k`` only caps the engine's speculative draft depth for THIS
    # request (None defers to the engine-wide ``SpecConfig.k``; 0 opts the
    # request out of speculation). It never changes emitted tokens — spec
    # decode is an execution strategy, not a sampling policy.

    def validate(self, max_len: int) -> None:
        if not self.prompt or self.max_new_tokens < 1:
            raise ValueError("prompts must be non-empty and max_new_tokens >= 1")
        if len(self.prompt) + self.max_new_tokens - 1 > max_len:
            raise ValueError(
                f"prompt({len(self.prompt)}) + max_new_tokens"
                f"({self.max_new_tokens}) exceeds max_len={max_len}")
        for name, dl in (("ttft_deadline", self.ttft_deadline),
                         ("deadline", self.deadline)):
            if dl is not None and dl < 1:
                raise ValueError(f"{name} must be >= 1 engine step, got {dl}")
        if self.arrival_step < 0:
            raise ValueError(
                f"arrival_step must be >= 0, got {self.arrival_step}")
        if self.spec_k is not None and self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")
        self.sampling.validate()


@dataclass
class GenerationResult:
    """Tokens emitted for one request (index-aligned with the request list).

    ``state`` is the request's lifecycle position — terminal after
    ``serve()`` returns, by engine contract. ``finish_reason`` mirrors it
    (``"length"``/``"eos"`` for FINISHED; the state's own string otherwise)
    and ``error`` carries the failure description for FAILED results.
    ``preemptions`` counts lane evictions this request survived (each one
    requeued it with its emitted tokens kept; resumption is bit-identical).

    ``reused_prefix_tokens`` counts prompt tokens served from the engine's
    content-hashed prefix store (shared system prompts / few-shot headers)
    instead of being prefilled — admission-time work the schedule skipped.
    Reuse never changes the emitted tokens, only the schedule.

    ``spec_proposed`` / ``spec_accepted`` count draft tokens proposed for /
    accepted into this request by speculative decoding (both 0 when the
    engine has no draft model). Like prefix reuse, speculation never changes
    the emitted tokens — only how many engine steps they cost.

    **Latency marks** (engine-step clock; the raw material for the TTFT/TPOT
    percentile telemetry in ``schedule_report()`` and the pimsim-priced
    ``serve.traffic.priced_latency`` report, which maps each mark onto
    ``pimsim.replay_events``' simulated timeline): ``arrival_step`` is when
    the request became visible to admission, ``admit_step`` when admission work FIRST started
    for it (set once — a preempted-then-requeued request keeps its original
    mark, so queue-wait is never double-counted), ``first_token_step`` when
    its first token emitted, ``finish_step`` when it reached a terminal
    state. TTFT is ``first_token_step - arrival_step``; TPOT is
    ``(finish_step - first_token_step) / (len(tokens) - 1)``.
    """

    tokens: list[int] = field(default_factory=list)
    finish_reason: str = FINISH_LENGTH    # "length"|"eos"|"timeout"|"cancelled"|"failed"
    prompt_len: int = 0
    reused_prefix_tokens: int = 0
    state: RequestState = RequestState.QUEUED
    error: Optional[str] = None           # set for FAILED results
    preemptions: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    arrival_step: int = 0                 # when admission could first see it
    admit_step: Optional[int] = None      # first admission work (set once)
    first_token_step: Optional[int] = None  # first emitted token
    finish_step: Optional[int] = None     # terminal-state transition

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES

    @property
    def ttft_steps(self) -> Optional[int]:
        """First-token latency in engine steps from arrival (None: no token
        ever emitted)."""
        if self.first_token_step is None:
            return None
        return self.first_token_step - self.arrival_step

    @property
    def tpot_steps(self) -> Optional[float]:
        """Mean inter-token latency in engine steps (None: fewer than two
        tokens, or the request never reached a terminal state)."""
        if (self.first_token_step is None or self.finish_step is None
                or len(self.tokens) < 2):
            return None
        return (self.finish_step - self.first_token_step) / (len(self.tokens) - 1)

    @property
    def queue_wait_steps(self) -> Optional[int]:
        """Steps from arrival to the FIRST admission attempt (None: never
        admitted). Preemption re-queues never re-accumulate here."""
        if self.admit_step is None:
            return None
        return self.admit_step - self.arrival_step
