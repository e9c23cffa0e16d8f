"""Traffic subsystem: arrival-driven load generation and step-domain latency
telemetry (the port's own copy of ``repro.serve.traffic``).

* :func:`generate` — a seeded load generator: Poisson (or fixed-gap)
  arrivals plus per-request prompt-length / token-budget / priority / SLO
  draws on the ENGINE-STEP clock, never wall time. One
  ``numpy.random.default_rng(seed)`` drives every draw in the JAX package's
  order, so a :class:`TrafficConfig` gives both packages the same trace.
* :class:`TrafficTrace` — the materialized schedule; round-trips losslessly
  through JSON (``save``/``load``); ``to_requests()`` gives the engine's
  :class:`~repro_torch.serve.api.GenerationRequest` list.
* :func:`latency_summary` — TTFT, TPOT and queue-wait p50/p95/p99 over the
  engine's latency marks, and step-budget SLO attainment; what
  ``Engine.schedule_report()`` embeds.
* :func:`priced_latency` — the same percentiles and SLO attainment in
  SIMULATED SECONDS: the event stream replayed through the port's own
  ``pimsim.replay_events`` and each latency mark mapped onto the simulated
  timeline with ``pimsim.clock_to_time``. The seconds are those of the
  paper's LPDDR5-PIM edge device model, not of the card the engine ran on.

Percentiles are nearest-rank (no interpolation), so integer step marks stay
integers and replays stay bit-identical.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Optional, Sequence

import numpy as np

from repro_torch.serve.api import GenerationRequest, RequestState, SamplingParams


@dataclass(frozen=True)
class TrafficConfig:
    """Parameters of a synthetic workload (all draws seeded; no wall clock).

    ``rate`` is mean arrivals per ENGINE STEP for the Poisson process
    (exponential gaps accumulated, then floored onto the step clock;
    simultaneous arrivals keep submission order). ``process="fixed"`` spaces
    arrivals ``gap`` steps apart. SLO fields are per-request step budgets
    from arrival (None opts out)."""

    n_requests: int = 16
    seed: int = 0
    process: str = "poisson"            # "poisson" | "fixed"
    rate: float = 0.25                  # poisson: mean arrivals per step
    gap: int = 4                        # fixed: inter-arrival steps
    prompt_len: tuple = (4, 24)         # inclusive [lo, hi] uniform draw
    max_new: tuple = (4, 16)            # inclusive [lo, hi] uniform draw
    vocab: int = 256                    # prompt token ids in [1, vocab)
    priorities: tuple = (0,)            # uniform draw over these values
    ttft_deadline: Optional[int] = None  # steps from arrival to first token
    deadline: Optional[int] = None       # steps from arrival to terminal

    def validate(self) -> None:
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got {self.n_requests}")
        if self.process not in ("poisson", "fixed"):
            raise ValueError(f"unknown arrival process {self.process!r}")
        if self.process == "poisson" and self.rate <= 0:
            raise ValueError(f"poisson rate must be > 0, got {self.rate}")
        if self.process == "fixed" and self.gap < 0:
            raise ValueError(f"fixed gap must be >= 0, got {self.gap}")
        for name, (lo, hi) in (("prompt_len", self.prompt_len), ("max_new", self.max_new)):
            if not 1 <= lo <= hi:
                raise ValueError(f"{name} bounds must satisfy 1 <= lo <= hi, got ({lo}, {hi})")
        if self.vocab < 2:
            raise ValueError(f"vocab must be >= 2, got {self.vocab}")
        if not self.priorities:
            raise ValueError("priorities must be non-empty")


@dataclass(frozen=True)
class TrafficRequest:
    """One generated request (the JSON-stable trace record)."""

    arrival_step: int
    prompt: tuple                       # token ids
    max_new_tokens: int
    priority: int = 0
    ttft_deadline: Optional[int] = None
    deadline: Optional[int] = None
    seed: int = 0                       # the request's private RNG-lane seed


@dataclass
class TrafficTrace:
    """A materialized request schedule and the config that produced it;
    ``save``/``load`` round-trip bit-exactly."""

    requests: list = field(default_factory=list)   # list[TrafficRequest]
    meta: dict = field(default_factory=dict)       # the generating config

    def to_json(self) -> dict:
        def native(v):  # JSON has no tuples: to_json == from_json(to_json).to_json()
            return list(v) if isinstance(v, tuple) else v
        return {"meta": {k: native(v) for k, v in self.meta.items()},
                "requests": [{k: native(v) for k, v in asdict(r).items()}
                             for r in self.requests]}

    @classmethod
    def from_json(cls, d: dict) -> "TrafficTrace":
        reqs = [TrafficRequest(
            arrival_step=int(r["arrival_step"]),
            prompt=tuple(int(t) for t in r["prompt"]),
            max_new_tokens=int(r["max_new_tokens"]),
            priority=int(r.get("priority", 0)),
            ttft_deadline=r.get("ttft_deadline"),
            deadline=r.get("deadline"),
            seed=int(r.get("seed", 0)),
        ) for r in d.get("requests", [])]
        return cls(requests=reqs, meta=dict(d.get("meta", {})))

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path) -> "TrafficTrace":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def to_requests(self, spec_k: Optional[int] = None) -> list[GenerationRequest]:
        """The engine-facing request list (index-aligned with the trace)."""
        return [GenerationRequest(
            prompt=list(r.prompt),
            max_new_tokens=r.max_new_tokens,
            sampling=SamplingParams(seed=r.seed),
            priority=r.priority,
            ttft_deadline=r.ttft_deadline,
            deadline=r.deadline,
            spec_k=spec_k,
            arrival_step=r.arrival_step,
        ) for r in self.requests]


def generate(cfg: TrafficConfig) -> TrafficTrace:
    """Materialize a :class:`TrafficTrace` from ``cfg`` (one
    ``np.random.default_rng(cfg.seed)`` drives every draw in a fixed order)."""
    cfg.validate()
    rng = np.random.default_rng(cfg.seed)
    reqs: list[TrafficRequest] = []
    t = 0.0
    for i in range(cfg.n_requests):
        if cfg.process == "poisson":
            t += float(rng.exponential(1.0 / cfg.rate))
            arrival = int(t)
        else:
            arrival = i * cfg.gap
        plen = int(rng.integers(cfg.prompt_len[0], cfg.prompt_len[1] + 1))
        prompt = tuple(int(x) for x in rng.integers(1, cfg.vocab, size=plen))
        max_new = int(rng.integers(cfg.max_new[0], cfg.max_new[1] + 1))
        prio = int(cfg.priorities[int(rng.integers(0, len(cfg.priorities)))])
        reqs.append(TrafficRequest(
            arrival_step=arrival, prompt=prompt, max_new_tokens=max_new,
            priority=prio, ttft_deadline=cfg.ttft_deadline,
            deadline=cfg.deadline, seed=cfg.seed * 1000003 + i))
    return TrafficTrace(requests=reqs, meta=asdict(cfg))


def percentile(values: Sequence, p: float):
    """Nearest-rank percentile: the smallest element with at least ``p``% of
    the sample at or below it. Integer inputs stay integers."""
    xs = sorted(values)
    if not xs:
        return None
    k = max(0, -(-int(p) * len(xs) // 100) - 1)  # ceil(p/100 * n) - 1
    return xs[min(k, len(xs) - 1)]


def _summary(values: Sequence) -> dict:
    xs = sorted(values)
    if not xs:
        return {"n": 0}
    return {"n": len(xs), "mean": sum(xs) / len(xs), "p50": percentile(xs, 50),
            "p95": percentile(xs, 95), "p99": percentile(xs, 99), "max": xs[-1]}


def latency_summary(results: Sequence, requests: Optional[Sequence] = None) -> dict:
    """TTFT/TPOT/queue-wait percentiles in the ENGINE-STEP domain, from the
    latency marks ``serve()`` stamps on each result. Marks derive from each
    request's arrival step, and ``admit_step``/``first_token_step`` are set
    once, so a preempted, requeued request counts its wait once. With
    ``requests`` (index-aligned) the SLO attainment is included: a request
    attains iff it FINISHED and met its declared deadlines."""
    ttfts = [r.ttft_steps for r in results if r.ttft_steps is not None]
    tpots = [r.tpot_steps for r in results if r.tpot_steps is not None]
    waits = [r.queue_wait_steps for r in results if r.queue_wait_steps is not None]
    states: dict[str, int] = {}
    for r in results:
        states[r.state.value] = states.get(r.state.value, 0) + 1
    out = {"requests": len(results), "states": states, "ttft_steps": _summary(ttfts),
           "tpot_steps": _summary(tpots), "queue_wait_steps": _summary(waits)}
    if requests is not None and len(requests) == len(results):
        met = declared = 0
        for rq, res in zip(requests, results):
            declared += bool(rq.ttft_deadline is not None or rq.deadline is not None)
            ok = res.state is RequestState.FINISHED
            if ok and rq.ttft_deadline is not None:
                ok = res.ttft_steps is not None and res.ttft_steps <= rq.ttft_deadline
            if ok and rq.deadline is not None:
                ok = (res.finish_step is not None
                      and res.finish_step - res.arrival_step <= rq.deadline)
            met += bool(ok)
        out["slo"] = {"declared": declared, "met": met,
                      "attainment": met / len(results) if results else 1.0}
    return out


# ------------------------------------------------------ priced (sim-seconds)


def priced_latency(events: Sequence, results: Sequence, model, dev, design,
                   draft_model=None, ttft_slo_s: Optional[float] = None,
                   tpot_slo_s: Optional[float] = None) -> dict:
    """TTFT/TPOT percentiles and SLO attainment in SIMULATED SECONDS.

    Replays ``events`` through :func:`repro_torch.pimsim.replay_events` (the
    calibrated CD-PIM timing model for ``model`` on ``dev``/``design``) and
    maps every latency mark (arrival, first token, finish) onto the replay's
    per-event timeline with :func:`repro_torch.pimsim.clock_to_time`. An LBIM
    fused step and an HBCEM split step advance the engine clock identically
    but the timeline differently, so mode choices move these numbers.

    SLO attainment (when ``ttft_slo_s``/``tpot_slo_s`` are given) is the
    fraction of ALL requests that FINISHED and met every declared target: a
    timed-out, failed or cancelled request never attains.
    """
    from repro_torch.pimsim import clock_to_time, replay_events
    rep = replay_events(events, model, dev, design, draft_model=draft_model)
    tl = rep.timeline
    ttfts: list[float] = []
    tpots: list[float] = []
    met = 0
    for r in results:
        arr_t = clock_to_time(tl, r.arrival_step)
        ttft_s = tpot_s = None
        if r.first_token_step is not None:
            ttft_s = clock_to_time(tl, r.first_token_step) - arr_t
            ttfts.append(ttft_s)
        if (r.first_token_step is not None and r.finish_step is not None
                and len(r.tokens) >= 2):
            tpot_s = ((clock_to_time(tl, r.finish_step)
                       - clock_to_time(tl, r.first_token_step))
                      / (len(r.tokens) - 1))
            tpots.append(tpot_s)
        ok = r.state is RequestState.FINISHED
        if ok and ttft_slo_s is not None:
            ok = ttft_s is not None and ttft_s <= ttft_slo_s
        if ok and tpot_slo_s is not None and len(r.tokens) >= 2:
            ok = tpot_s is not None and tpot_s <= tpot_slo_s
        met += bool(ok)
    n = len(results)
    return {
        "total_s": rep.total_s,
        "idle_steps": rep.idle_steps,
        "ttft_s": _summary(ttfts),
        "tpot_s": _summary(tpots),
        "slo": {
            "ttft_slo_s": ttft_slo_s,
            "tpot_slo_s": tpot_slo_s,
            "met": met,
            "requests": n,
            "attainment": met / n if n else 1.0,
        },
        "replay": rep.to_json(),
    }
