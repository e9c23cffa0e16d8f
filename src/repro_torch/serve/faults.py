"""Deterministic, seeded fault injection for the serving engine (the port's
own copy of ``repro.serve.faults``).

Every :class:`FaultPlan` is a pure function of ``(seed, horizon, rates)`` —
no wall clock, no global RNG — so a plan that exposes a leak replays it
bit-identically. ``FaultPlan.seeded`` draws from
``numpy.random.default_rng(seed)`` in the JAX package's order, so one seed
gives both packages the same plan. The engine consults the plan where a real
deployment fails:

* ``alloc_fail``   — lane allocation fails although a lane is free
  (fragmentation / contention); the engine answers with preempt-or-park.
* ``kernel_exc``   — the step raises :class:`KernelFault` for one ladder op.
  Fired only while that op runs a kernel (``DegradationLadder.kernel_live``):
  in the port that is the CUDA kernel on the card, never the CPU's plain
  version.
* ``nan_logits``   — the step's logits become NaN; the JAX engine fires it
  only while some op can still degrade. The port's ladder has one rung, so
  its engine never fires it (nor does the JAX engine at its floor); the NaN
  guard still trips on real non-finite logits.
* ``slow_step``    — the step costs ``penalty`` extra engine steps of clock;
  drives the deadline machinery without faking token content.

Faults are one-shot: each fires at the first check at or after its step,
then is spent.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

KINDS = ("alloc_fail", "kernel_exc", "nan_logits", "slow_step")
_OPS = ("decode_attention", "pim_gemv")


@dataclass
class Fault:
    """One armed fault: fires once at the first check at/after ``step``."""

    kind: str            # one of KINDS
    step: int            # engine-step clock index (from serve() start)
    op: str = "decode_attention"  # kernel_exc: which ladder op faults
    penalty: int = 0     # slow_step: extra engine steps of clock
    fired: bool = False

    def to_json(self) -> dict:
        return {"kind": self.kind, "step": self.step, "op": self.op,
                "penalty": self.penalty, "fired": self.fired}


@dataclass
class FaultPlan:
    """A deterministic schedule of faults, consumed by one ``serve()`` call."""

    faults: list[Fault] = field(default_factory=list)
    seed: int = 0

    @classmethod
    def seeded(cls, seed: int, horizon: int = 32, n_faults: int = 4,
               kinds: tuple[str, ...] = KINDS) -> "FaultPlan":
        """Draw ``n_faults`` faults over ``[1, horizon)`` steps from ``seed``."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            faults.append(Fault(
                kind=kind,
                step=int(rng.integers(1, max(horizon, 2))),
                op=_OPS[int(rng.integers(len(_OPS)))],
                penalty=int(rng.integers(1, 4)) if kind == "slow_step" else 0,
            ))
        faults.sort(key=lambda f: f.step)
        return cls(faults=faults, seed=seed)

    def take(self, clock: int, kind: str, *, pred=None) -> "Fault | None":
        """Pop (mark fired) the first unfired ``kind`` fault due at or before
        ``clock``; ``pred`` filters candidates (e.g. op still kernel-live)."""
        for f in self.faults:
            if f.fired or f.kind != kind or f.step > clock:
                continue
            if pred is not None and not pred(f):
                continue
            f.fired = True
            return f
        return None

    def pending(self) -> int:
        return sum(1 for f in self.faults if not f.fired)

    def fired(self) -> int:
        return sum(1 for f in self.faults if f.fired)

    def to_json(self) -> dict:
        return {"seed": self.seed, "fired": self.fired(),
                "pending": self.pending(),
                "faults": [f.to_json() for f in self.faults]}
