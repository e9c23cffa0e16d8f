"""Typed serving errors (the port's own copy of ``repro.serve.errors``).

:class:`PoolExhausted` carries a :class:`PoolOccupancy` snapshot;
:class:`AdmissionRejected` is backpressure at the scheduler's bounded queue;
:class:`EngineStateError` is an invariant violation; :class:`KernelFault`
names the op of a failed step (a kernel error, an injected fault or a
non-finite logit); all inherit :class:`ServingError`.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PoolOccupancy:
    """Point-in-time capacity snapshot of a :class:`~repro_torch.serve.cache.CachePool`.

    ``pages_*`` describe the prefix store's physical page pool (zero when the
    store is disabled or the family is not prefix-capable); ``prefix_pins``
    counts distinct store pages currently referenced by ACTIVE slots' block
    tables — pages an eviction policy must treat as hot.
    """

    slots_total: int
    slots_used: int
    pages_total: int
    pages_used: int
    prefix_pins: int

    @property
    def slots_free(self) -> int:
        return self.slots_total - self.slots_used

    @property
    def pages_free(self) -> int:
        return self.pages_total - self.pages_used

    def to_json(self) -> dict:
        return {
            "slots_total": self.slots_total, "slots_used": self.slots_used,
            "slots_free": self.slots_free, "pages_total": self.pages_total,
            "pages_used": self.pages_used, "pages_free": self.pages_free,
            "prefix_pins": self.prefix_pins,
        }


class ServingError(RuntimeError):
    """Base of every typed serving failure."""


class PoolExhausted(ServingError):
    """No lane (or page) could be claimed; carries the occupancy snapshot."""

    def __init__(self, message: str, occupancy: PoolOccupancy, injected: bool = False):
        super().__init__(f"{message} [occupancy: slots {occupancy.slots_used}/"
                         f"{occupancy.slots_total} used, pages "
                         f"{occupancy.pages_used}/{occupancy.pages_total} used,"
                         f" {occupancy.prefix_pins} pinned]")
        self.occupancy = occupancy
        self.injected = injected  # raised by a FaultPlan, not real pressure


class AdmissionRejected(ServingError):
    """Bounded admission queue is full — the submit was refused."""

    def __init__(self, depth: int, max_queue: int):
        super().__init__(
            f"admission queue full ({depth}/{max_queue}); retry after a "
            f"drain or raise Scheduler.max_queue")
        self.depth = depth
        self.max_queue = max_queue


class EngineStateError(ServingError):
    """The engine was driven in an order its state machine does not allow."""


class KernelFault(ServingError):
    """A kernel-level failure attributed to one dispatched op (``op``) —
    a non-finite step or one injected by a
    :class:`~repro_torch.serve.faults.FaultPlan`. The engine counts it on
    the degradation ladder; with no rung below (the port's ladder has none,
    see ``core.dispatch``) it fails the step's participants."""

    def __init__(self, op: str, message: str = "", injected: bool = False):
        super().__init__(message or f"kernel fault in {op!r}")
        self.op = op
        self.injected = injected
