"""Operating modes — the paper's Table II instruction set as scheduler policy.

The port's own copy of ``repro.core.pim_modes`` (``Mode``, ``StepPlan``,
``plan_step``); per-step policies wait for the traffic slice.

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
