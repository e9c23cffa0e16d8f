"""Speculative decoding: draft/verify lanes on the copy-on-write paged pool
(port of ``repro.serve.spec``).

LP-Spec (PAPERS.md) observes that LPDDR-PIM is where draft/verify pays off:
drafting is the GEMV-bound low-batch work the PIM banks accelerate, and
verifying k tokens at once is GEMM-shaped work, so speculation makes the
paper's LBIM mixed workload from within ONE request stream.

**Protocol per engine step** (``Engine.serve`` drives it; the step plan
carries ``spec=True``):

1. Each active lane's draft model rolls out up to ``k`` greedy candidates on
   its own lane of a separate, contiguous draft
   :class:`~repro_torch.serve.cache.CachePool` (slot ``i`` mirrors target
   slot ``i``).
2. The target scores all ``k+1`` positions of every lane over a **forked**
   block-table row (:meth:`CachePool.fork_lane`). Each position runs through
   the SAME ``(slots, 1)`` decode program plain decode uses (the paged
   flash-decode kernel and the W8A8 GEMVs on the card), committed into the
   forked row before the next; rejected suffixes are rolled back and every
   page is released exactly once (``check_invariants`` audits live forks).
3. Acceptance is **token matching**: at verify position ``j`` the target
   samples ``s_j`` from its own logits with the key the non-spec engine
   would use (``token_key(base, emitted + j)``), and draft token ``d_j`` is
   accepted iff ``d_j == s_{j-1}``. The emitted stream ``s_0..s_a`` is
   therefore the non-spec engine's at EVERY temperature; the draft only
   changes how many steps it costs.

**Draft lane protocol** (anchor/catch-up): a lane's draft cache holds the
first ``fed`` tokens of the request's context and ``pending`` is the suffix
not yet fed (at least the current token). A rollout copies the lane into
the decoder's one batch-1 working lane (:meth:`CachePool.extract_lane_into`),
feeds ``pending`` in one T-general catch-up step, copies the result (real
tokens only) into the slot's anchor buffer, then chains ``k-1``
single-token feeds on the working lane. Only
:meth:`SpecDecoder.finish_round` writes the anchor back into the pool, so a
failed or retried round leaves the draft pool as it was. The catch-up of
more than one token takes the dense multi-token form
(``models/attention.py``); a catch-up of one token and the chained feeds run
the contiguous flash-decode kernel and the W8A8 GEMVs.

The feeds are the engine's ``decode_only_step`` program: they run through
the engine's :class:`~repro_torch.core.interleave.StepGraphs`, as the JAX
rollout calls the same jitted function as plain decode. The working lane,
its ``pos`` and the anchors are allocated once and keep their addresses, so
a feed's key depends only on its token count: on the card every catch-up
length and the chained feed capture once and replay in every later round.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core import interleave
from repro_torch.models import model as M
from repro_torch.serve import sampling
from repro_torch.serve.cache import ACTIVE, CachePool
from repro_torch.serve.errors import EngineStateError


@dataclass(frozen=True)
class SpecConfig:
    """Engine-level speculative decoding config: a prepared draft
    ``ServingModel`` and the maximum draft depth ``k``. A request's
    ``spec_k`` may cap ``k`` further (0 opts it out)."""

    draft: object            # ServingModel (typed loosely: import-cycle-free)
    k: int = 4

    def validate(self) -> None:
        if self.k < 1:
            raise ValueError(f"SpecConfig.k must be >= 1, got {self.k}")


@dataclass
class _DraftLane:
    """One slot's draft-side state: the request it mirrors, the context
    tokens its cache holds (``fed``), and the suffix not yet fed
    (``pending``, which ends with the request's current token)."""

    rid: int
    fed: int
    pending: list = field(default_factory=list)


@dataclass
class _RoundState:
    """One lane's in-flight round: the slot's anchor buffers holding the
    post-catch-up cache (real tokens only), its fill, the proposed
    candidates, the single-token feeds spent chaining them, and the catch-up
    tokens ingested in one pass."""

    anchor: dict
    anchor_fed: int
    drafts: list
    steps: int
    catchup: int


class SpecDecoder:
    """The draft side of speculative decoding: a contiguous mirror pool
    (slot ``i`` ↔ target slot ``i``), lazy lane sync by prefill, greedy
    rollouts and the anchor/catch-up bookkeeping. The engine owns
    scheduling, forking, the verify pass and acceptance."""

    def __init__(self, draft, target, *, slots: int, max_len: int, k: int,
                 graphs: Optional[interleave.StepGraphs] = None):
        if k < 1:
            raise ValueError(f"draft depth k must be >= 1, got {k}")
        if draft.cfg.vocab_size != target.cfg.vocab_size:
            raise ValueError(
                f"draft vocab ({draft.cfg.vocab_size}) != target vocab "
                f"({target.cfg.vocab_size}): draft tokens would be meaningless "
                f"to the verifier")
        self.draft = draft
        self.k = int(k)
        # rollouts transiently run k-1 tokens past the target's max context
        self.max_len = int(max_len) + self.k + 1
        self.pool = CachePool(draft.cfg, self.max_len, slots, prefix_cache=False,
                              paged=False, device=draft.device)
        if not self.pool.policy.chunkable:
            raise ValueError(
                f"draft model {draft.cfg.name!r} has a ring cache: the "
                f"catch-up feed is multi-token, which rings cannot ingest")
        self._lanes: dict[int, _DraftLane] = {}
        self._round: dict[int, _RoundState] = {}
        self._prefill_tokens = 0
        # the engine's captured programs; the working lane the feeds run on and
        # one anchor per slot, each allocated at first use and kept
        self.graphs = graphs
        self._work: Optional[dict] = None
        self._anchors: dict[int, dict] = {}
        self.catchup_lengths: set[int] = set()

    @property
    def draft_cfg(self):
        return self.draft.cfg

    # ----------------------------------------------------------- lifecycle

    def reset(self) -> None:
        """Serve-start state: no lanes, no round, fresh draft pool."""
        self._lanes.clear()
        self._round.clear()
        self._prefill_tokens = 0
        self.pool.reset()

    def begin_round(self) -> None:
        """Open one draft/verify round."""
        self._round.clear()
        self._prefill_tokens = 0

    def abort_round(self) -> None:
        """The round's step failed: discard in-flight anchors. Lanes keep their
        last committed state (rollouts wrote into the working lane and the
        anchors, never the pool)."""
        self._round.clear()

    def prune(self, active_map: dict) -> None:
        """Retire draft lanes whose slot no longer runs their request
        (``active_map``: target slot -> request id)."""
        for si in list(self._lanes):
            if active_map.get(si) != self._lanes[si].rid:
                self.retire_lane(si)

    def retire_lane(self, si: int) -> None:
        """Drop slot ``si``'s draft lane (its target lane retired)."""
        self._round.pop(si, None)
        self._lanes.pop(si, None)
        if self.pool.get(si).state == ACTIVE:
            self.pool.retire(si)

    def note_emitted(self, si: int, toks) -> None:
        """Tokens emitted outside a spec round extend the lane's pending
        suffix, keeping the catch-up invariant without a resync."""
        lane = self._lanes.get(si)
        if lane is not None:
            lane.pending.extend(int(t) for t in toks)

    # --------------------------------------------------------------- rounds

    def ensure_lane(self, si: int, rid: int, request, context, cfg) -> int:
        """Make slot ``si`` hold a draft lane for ``rid`` whose cache and
        pending suffix exactly cover ``context`` (prompt + emitted tokens).
        A valid lane is free; a stale or missing one costs one draft prefill
        of ``len(context) - 1`` tokens (returned).

        The JAX package prefills with ``M.prefill``, which the port has for
        every family but the hybrid; the stand-in for every draft family is the
        batch-prefill form the port admits with
        (``interleave.prefill_chunk_step(..., gemm=True)``: float GEMMs and
        dense attention over the whole span in one pass) into a fresh batch-1
        contiguous cache, whose ``pos`` is then the prefilled length."""
        lane = self._lanes.get(si)
        ctx = [int(t) for t in context]
        if (lane is not None and lane.rid == rid
                and lane.fed + len(lane.pending) == len(ctx)
                and lane.pending == ctx[lane.fed:]):
            return 0
        if len(ctx) < 2:
            raise EngineStateError(
                f"spec lane sync with context of {len(ctx)} token(s): an active "
                f"lane has emitted at least one token")
        self.retire_lane(si)
        n = len(ctx) - 1
        dev = self.draft.device
        cache = M.init_decode_cache(cfg, 1, self.max_len, device=dev)
        cache["pos"] = torch.zeros((1,), dtype=torch.int32, device=dev)
        toks = torch.as_tensor(np.asarray([ctx[:-1]], np.int64), device=dev)
        _, cache = interleave.prefill_chunk_step(self.draft.params, cache, toks, cfg,
                                                 gemm=True)
        self.pool.alloc(request, rid, slot=si, ctx=n)
        self.pool.insert(si, cache, fill=n)
        self._lanes[si] = _DraftLane(rid=rid, fed=n, pending=[ctx[-1]])
        self._prefill_tokens += n
        return n

    def rollout(self, si: int, k: int, cfg) -> list[int]:
        """Roll out ``k`` greedy draft candidates for slot ``si``.

        The lane is copied into the working lane and the pending suffix fed
        in ONE catch-up step, whose cache is copied into the slot's anchor;
        ``k-1`` single-token feeds chain the remaining candidates on the
        working lane (decode steps write in place, and a hybrid draft's
        recurrent state would otherwise move on past the anchor). Nothing
        lands in the pool until :meth:`finish_round`."""
        lane = self._lanes[si]
        dparams = self.draft.decode_params
        work = self.pool.extract_lane_into(si, self._working_lane())
        logits, _ = interleave.decode_only_step(dparams, work, _host_tokens(lane.pending),
                                                cfg, graphs=self.graphs)
        drafts = [int(sampling.greedy(logits)[0])]
        anchor = self._anchors.get(si)
        if anchor is None:
            anchor = self._anchors[si] = self.pool.lane_buffers()
        for key, t in work.items():
            anchor[key].copy_(t)            # in place: the round's anchor
        self.catchup_lengths.add(len(lane.pending))
        steps = 0
        for _ in range(int(k) - 1):
            logits, _ = interleave.decode_only_step(dparams, work, _host_tokens([drafts[-1]]),
                                                    cfg, graphs=self.graphs)
            drafts.append(int(sampling.greedy(logits)[0]))
            steps += 1
        self._round[si] = _RoundState(anchor, lane.fed + len(lane.pending), drafts, steps,
                                      catchup=len(lane.pending))
        return list(drafts)

    def _working_lane(self) -> dict:
        if self._work is None:
            self._work = self.pool.lane_buffers()
        return self._work

    def graph_keys(self) -> int:
        """Keys of the engine's ``StepGraphs`` whose cache is the working
        lane: one per catch-up length, the chained feed sharing length 1's."""
        if self.graphs is None or self._work is None:
            return 0
        return self.graphs.keys_over(self._work["pos"])

    def finish_round(self, si: int, emitted) -> None:
        """Commit slot ``si``'s round: the anchor (context up to and including
        the round's input token) enters the draft pool and the round's
        emitted tokens become the new pending suffix. A lane without a
        rollout this round (its ``spec_k`` floor) only extends pending."""
        rs = self._round.pop(si, None)
        lane = self._lanes.get(si)
        if rs is None:
            self.note_emitted(si, emitted)
            return
        if lane is None:
            raise EngineStateError(f"finish_round({si}) with a rollout but no draft lane")
        self.pool.insert(si, rs.anchor, fill=rs.anchor_fed)
        lane.fed = rs.anchor_fed
        lane.pending = [int(t) for t in emitted]

    def round_stats(self) -> dict:
        """The round's draft work for the engine's ``ScheduleEvent``:
        chained single-token feeds, candidates proposed, the lanes that
        rolled out and how many of their catch-ups fed one token (a decode
        step, like a chained feed), and the tokens of every multi-token
        draft pass (lane resync prefills and catch-ups)."""
        return {
            "draft_steps": sum(rs.steps for rs in self._round.values()),
            "rollouts": len(self._round),
            "catchup_decodes": sum(rs.catchup == 1 for rs in self._round.values()),
            "drafted": sum(len(rs.drafts) for rs in self._round.values()),
            "draft_prefill_tokens": self._prefill_tokens + sum(
                rs.catchup for rs in self._round.values()),
        }


def _host_tokens(toks) -> torch.Tensor:
    """A (1, T) int64 host row of draft tokens: a step program copies it into
    its graph's static buffer (or onto the draft's device when eager)."""
    return torch.from_numpy(np.asarray([toks], np.int64))
