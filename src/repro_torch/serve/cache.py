"""Typed ``CachePool``: slot table + per-family cache state + paged residency
(port of ``repro.serve.cache``).

Which states a pool holds is derived from the config's decode-cache structure
(:func:`derive_state_specs`), and so is the admission policy
(:func:`derive_policy`): dense KV alone pages; a hybrid (zamba2) keeps its
shared block's KV in contiguous lanes beside recurrent Mamba2 states that are
zeroed on retire, and admits ragged batches one request at a time; rwkv6
keeps recurrent state alone (no KV at all), with the same policy; a windowed
gemma2 (``windowed_kv_cache``) keeps its global layers' KV in contiguous
lanes beside W-slot rings, which cannot ingest a chunk, so each request
admits through one full prefill; the audio decoder keeps its self-KV lanes
beside the static encoder memory (``cross_k``/``cross_v``: copied at insert,
never appended to, never zeroed).

:class:`PagedKVState` owns ONE physical page pool in the paper's §III-C dual
layout — K pages column-wise ``(hd, Bsz)``, V pages row-wise ``(Bsz, hd)``,
layer-stacked — shared by the live lanes, the in-flight admission stream and
the content-hashed prefix index. Block tables and refcounts are host numpy;
the page tensors live on the pool's device. Pages are refcounted: an active
lane's table row, the staging stream's handle and the prefix index each hold
one reference per page, and a page returns to the free list exactly when its
count reaches zero (:meth:`CachePool.check_invariants` audits this).

Differences from the JAX package, none of which changes a token:

* Page writes are IN PLACE. The JAX admission stream forked the pool arrays
  and its fresh pages were copied back at insert; here the stream writes its
  fresh pages directly into the pool tensors. The stream and the decode lanes
  write disjoint pages (fresh pages belong to the stream alone, shared prefix
  pages are full blocks below every owner's append point), so the two are
  equivalent and insert only transfers the table row.
* Batch admission (an empty pool) fills pages through the same staging
  stream, one request at a time, instead of pagifying a contiguous prefill
  cache: :meth:`CachePool.begin_batch_admission`. A token-coupled config
  (MoE) admits as the JAX engine does, through one ragged prefill whose lanes
  are cut into pages at insert (:meth:`PagedKVState.pagify`).
* Contiguous lanes (:class:`LaneState`, one per :class:`StateSpec`) are
  written in place too: insert copies one lane, retire zeroes one lane of
  the recurrent leaves, and the decode step writes each layer's slice.
* Speculative decoding's fork / restore / rollback keeps the JAX protocol
  (:meth:`CachePool.fork_lane`). Because pages are written in place, the
  copy-on-write that the JAX package does defensively is load-bearing here:
  a verify branch's first append into a page the fork still references
  copies that page first (:meth:`PagedKVState.ensure_residency`), so the
  snapshot a restore reinstates was never written. And
  :meth:`CachePool.extract_lane` returns a COPY of a contiguous lane (the
  JAX view was safe because its updates were functional): a draft rollout
  writes into the copy, and the pool changes only when the round commits.
* The audio family's pool is built as the JAX package builds it, with an
  encoder memory of length 0: only ``models.model.prefill(src_frames=)``
  fills one, and the engine's admission passes no frames, so an audio serve
  fails at admission (a ``ValueError`` naming ``src_frames`` here, a
  ``KeyError: 'src_frames'`` in the JAX engine).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kv_mapping
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.errors import EngineStateError, PoolExhausted, PoolOccupancy

FREE, ACTIVE = "free", "active"

# KV lanes and rings are masked by position; every OTHER leaf of a decode
# cache (but ``pos``) is recurrent state that must be zeroed when a lane is
# retired, so a new family's novel keys are zero-on-retire by default.
KV_KEYS = ("k", "v")
RING_KEYS = ("k_loc", "v_loc")
STATIC_KEYS = ("cross_k", "cross_v")

# Physical page 0 is a permanently pinned dummy: free lanes' block tables
# resolve to it so their masked garbage decodes have somewhere harmless to land.
DUMMY_PAGE = 0


# ===========================================================================
# lane surgery primitives (in place)
# ===========================================================================


def _copy_lane(dst: torch.Tensor, src: torch.Tensor, slot: int, src_slot: int = 0) -> None:
    """Lane ``src_slot`` of a stacked (nL, B, ...) leaf into lane ``slot`` of
    ``dst``, IN PLACE."""
    dst[:, slot].copy_(src[:, src_slot])


def _zero_lane(arr: torch.Tensor, slot: int) -> None:
    arr[:, slot].zero_()    # in place


def _upload(dst: torch.Tensor, values) -> torch.Tensor:
    """Host ``values`` into the persistent tensor ``dst``, IN PLACE; returns
    ``dst``. On the card the copy leaves from pinned memory without a host
    sync, ordered on the stream after every step launched before it."""
    src = torch.from_numpy(np.ascontiguousarray(values, dtype=np.int32)).reshape(dst.shape)
    if dst.device.type == "cuda":
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)
    return dst


# ===========================================================================
# cache-state specs: derived, not declared per family
# ===========================================================================


@dataclass(frozen=True)
class StateSpec:
    """One cache family present in a config's decode cache."""

    kind: str                 # "paged_kv" | "ring" | "recurrent" | "static"
    keys: tuple[str, ...]
    zero_on_retire: bool


def derive_state_specs(cfg: ModelConfig) -> tuple[StateSpec, ...]:
    """Decompose a config's decode-cache structure into typed state specs:
    the KV pair, gemma2's ring pair, the audio decoder's static encoder
    memory, then every leftover leaf as recurrent state (zeroed on retire).
    Built from the cache's shapes alone (no allocation)."""
    keys = {k for k in M.decode_cache_specs(cfg, 1, 8) if k != "pos"}
    specs: list[StateSpec] = []
    claimed: set[str] = set()
    if set(KV_KEYS) <= keys:
        specs.append(StateSpec("paged_kv", KV_KEYS, False))
        claimed |= set(KV_KEYS)
    if set(RING_KEYS) <= keys:
        specs.append(StateSpec("ring", RING_KEYS, False))
        claimed |= set(RING_KEYS)
    static = tuple(sorted(set(STATIC_KEYS) & keys))
    if static:
        specs.append(StateSpec("static", static, False))
        claimed |= set(static)
    recurrent = tuple(sorted(keys - claimed))
    if recurrent:
        specs.append(StateSpec("recurrent", recurrent, True))
    return tuple(specs)


@dataclass(frozen=True)
class AdmissionPolicy:
    """What the engine may do at admission, derived from the state specs, so
    the engine itself never branches on a cache family."""

    chunkable: bool        # False: rings admit only through one full prefill
    ragged_batch_ok: bool  # False: recurrent/ring states reject padded ragged batches
    prefix_capable: bool   # True: KV is the whole state -> prefix reuse is sound


def derive_policy(specs: tuple[StateSpec, ...]) -> AdmissionPolicy:
    kinds = {s.kind for s in specs}
    return AdmissionPolicy(chunkable="ring" not in kinds,
                           ragged_batch_ok=kinds <= {"paged_kv", "static"},
                           prefix_capable=kinds == {"paged_kv"})


# ===========================================================================
# typed contiguous states
# ===========================================================================


class LaneState:
    """One contiguous state of the pool: a dict of stacked (nL, B, ...) lane
    leaves, as its spec names them. Dense KV (hybrid and windowed configs,
    where KV is not the whole cache state, and pools built with
    ``paged=False``) and gemma2's W-slot rings are masked by position, and
    the audio decoder's static encoder memory is read whole by its own
    request only: these are copied at insert, never zeroed. Recurrent leaves
    (Mamba2's ``ssd``/``conv_x``/``conv_bc``, rwkv6's ``wkv``/``att_tail``/
    ``ffn_tail``) are not masked, so their spec has ``zero_on_retire`` and a
    retired lane is zeroed before it is reused."""

    def __init__(self, spec: StateSpec, leaves: dict):
        self.spec = spec
        self.leaves = {k: leaves[k] for k in spec.keys}

    def insert(self, src_cache: dict, slot: int, src_slot: int = 0) -> None:
        for k in self.spec.keys:
            _copy_lane(self.leaves[k], src_cache[k], slot, src_slot)

    def retire(self, slot: int) -> None:
        if self.spec.zero_on_retire:
            for k in self.spec.keys:
                _zero_lane(self.leaves[k], slot)

    def views(self) -> dict:
        return dict(self.leaves)

    def commit(self, new_cache: dict) -> None:
        # the decode step wrote the leaves in place; take its tensors as they are
        for k in self.spec.keys:
            self.leaves[k] = new_cache[k]

    def reset(self) -> None:
        for leaf in self.leaves.values():
            leaf.zero_()    # in place: fresh lanes without a second allocation


class _PagesExhausted(Exception):
    """Internal: the physical page pool ran dry (re-raised as PoolExhausted)."""


@dataclass
class _StagingHandle:
    """The (single) in-flight admission stream's page residency: its
    logical->physical table, the pages allocated for its own writes and its
    fill (host side: the tokens staged so far)."""

    table: np.ndarray
    fresh: list = field(default_factory=list)
    fill: int = 0


class PagedKVState:
    """Fully paged dense KV: one refcounted physical page pool shared by live
    lanes, the admission stream and the prefix index."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int, block_size: int, *,
                 store_pages: int, prefix_cache: bool, dtype, device, spec_slack: int = 0):
        self.block_size = int(block_size)
        # ``spec_slack`` buys each lane room for a speculative verify round's
        # TRANSIENT k+1 appends beyond max_len (rolled back before the lane can
        # be observed at that fill)
        self.n_blocks = -(-(int(max_len) + max(int(spec_slack), 0)) // self.block_size)
        self.n_slots = int(n_slots)
        self.prefix_cache = bool(prefix_cache)
        self.store_capacity = int(store_pages) if self.prefix_cache else 0
        # worst-case distinct pages: every slot full + the staging stream full
        # + a saturated prefix index, all disjoint, + the dummy
        self.capacity = (self.n_slots + 1) * self.n_blocks + self.store_capacity + 1
        self.device = device
        self.pages = kv_mapping.init_paged_cache(
            cfg.n_layers, self.capacity, cfg.n_kv_heads, cfg.head_dim,
            self.block_size, dtype, device)
        self.refcount = np.zeros((self.capacity,), np.int64)
        self.refcount[DUMMY_PAGE] = 1
        self._free = list(range(self.capacity - 1, DUMMY_PAGE, -1))
        self.block_tables = np.full((self.n_slots, self.n_blocks), -1, np.int64)
        # the step's inputs live in persistent tensors, refreshed in place from
        # the host tables before each step: a captured step reads fixed addresses
        self._table_dev = torch.zeros((self.n_slots, self.n_blocks), dtype=torch.int32,
                                      device=device)
        self._staging_table_dev = torch.zeros((1, self.n_blocks), dtype=torch.int32,
                                              device=device)
        self._staging_pos_dev = torch.zeros((1,), dtype=torch.int32, device=device)
        self._index: OrderedDict[bytes, int] = OrderedDict()
        self.staging: Optional[_StagingHandle] = None
        # live fork rows (identity-keyed): each holds one ref per page and is
        # part of the audit's expected-refcount reconstruction
        self._forks: list[np.ndarray] = []
        # drained batch-admission streams waiting for their lane (their refs
        # are audited like the open stream's)
        self._parked: list[_StagingHandle] = []

    def __len__(self) -> int:
        """Indexed prefix entries (``prefix_report``'s ``stored_blocks``)."""
        return len(self._index)

    def pages_used(self) -> int:
        """Referenced pages, dummy excluded."""
        return int((self.refcount > 0).sum()) - 1

    # -------------------------------------------------------- page refcounts

    def _ref(self, p: int) -> None:
        self.refcount[p] += 1

    def _unref(self, p: int) -> None:
        self.refcount[p] -= 1
        if self.refcount[p] == 0:
            self._free.append(int(p))

    def _alloc_page(self) -> int:
        """A fresh page (refcount 1), evicting LRU store-only entries under pressure."""
        if self._free:
            p = self._free.pop()
            self.refcount[p] = 1
            return int(p)
        for key in list(self._index):  # LRU order
            p = self._index[key]
            if self.refcount[p] == 1:  # only the index pin holds it
                del self._index[key]
                self.refcount[p] = 1   # the pin transfers to the caller
                return int(p)
        raise _PagesExhausted(
            f"no free page among {self.capacity} (all lane- or prefix-referenced)")

    def _drop_row(self, slot: int) -> None:
        for p in self.block_tables[slot]:
            if p >= 0:
                self._unref(int(p))
        self.block_tables[slot] = -1

    # ----------------------------------------------------------- prefix index

    def _key(self, prompt, i: int) -> bytes:
        return np.asarray(prompt[: (i + 1) * self.block_size], np.int32).tobytes()

    def match_prefix(self, prompt) -> list[int]:
        """Longest indexed block-chain prefix of ``prompt``, capped one token
        short of the full prompt. Returns physical page ids in logical order."""
        if not self.prefix_cache:
            return []
        max_blocks = max(len(prompt) - 1, 0) // self.block_size
        pages: list[int] = []
        for i in range(max_blocks):
            phys = self._index.get(self._key(prompt, i))
            if phys is None:
                break
            self._index.move_to_end(self._key(prompt, i))  # LRU touch
            pages.append(phys)
        return pages

    def harvest(self, slot: int, prompt) -> None:
        """Index every full prompt block resident in ``slot``'s table in place
        (refcount pin, no copy); a key collision keeps the indexed page."""
        if not self.prefix_cache:
            return
        for i in range(len(prompt) // self.block_size):
            p = int(self.block_tables[slot, i])
            if p < 0:
                break
            key = self._key(prompt, i)
            if key in self._index:
                self._index.move_to_end(key)
            elif len(self._index) < self.store_capacity or self._evict_one():
                self._index[key] = p
                self._ref(p)

    def _evict_one(self) -> bool:
        for key in list(self._index):  # LRU order
            p = self._index[key]
            if self.refcount[p] == 1:
                del self._index[key]
                self._unref(p)
                return True
        return False

    # ------------------------------------------------------------- residency

    def ensure_residency(self, slot: int, pos: int, n_tokens: int = 1) -> None:
        """Page-in ``slot``'s write blocks for the next ``n_tokens`` appends
        starting at ``pos``; copy-on-write any such block that is shared (a
        forked lane's partial write block): the copy is made before the decode
        step writes in place, so the fork's page is never written."""
        last = min(pos + max(int(n_tokens), 1), self.n_blocks * self.block_size) - 1
        if last < pos:
            return  # at capacity: the engine retires before appending
        for wb in range(pos // self.block_size, last // self.block_size + 1):
            p = int(self.block_tables[slot, wb])
            if p < 0:
                self.block_tables[slot, wb] = self._alloc_page()
            elif self.refcount[p] > 1:
                q = self._alloc_page()
                self.pages["k_pages"][:, q].copy_(self.pages["k_pages"][:, p])  # in place
                self.pages["v_pages"][:, q].copy_(self.pages["v_pages"][:, p])  # in place
                self.block_tables[slot, wb] = q
                self._unref(p)

    # -------------------------------------------------------- fork / rollback

    def fork_row(self, slot: int) -> np.ndarray:
        """Snapshot ``slot``'s table row: one extra ref per page, no page
        content copied. The row is registered live for the audit."""
        row = self.block_tables[slot].copy()
        for p in row:
            if p >= 0:
                self._ref(int(p))
        self._forks.append(row)
        return row

    def _forget_fork(self, row: np.ndarray) -> None:
        for i, r in enumerate(self._forks):
            if r is row:
                del self._forks[i]
                return
        raise EngineStateError("fork row is not registered (released twice?)")

    def restore_row(self, slot: int, row: np.ndarray) -> None:
        """Reinstate a fork: the lane's current row (with any pages the branch
        wrote) is released and the snapshot's row and refs go back to the slot.
        Bit-identical, because the branch copied a shared write block before
        writing it."""
        self._forget_fork(row)
        self._drop_row(slot)
        self.block_tables[slot] = row

    def drop_fork_row(self, row: np.ndarray) -> None:
        """Release a fork's references (the accept path, after rollback)."""
        self._forget_fork(row)
        for p in row:
            if p >= 0:
                self._unref(int(p))

    def rollback(self, slot: int, pos: int) -> None:
        """Truncate ``slot`` to fill level ``pos``: release every block at or
        beyond the first dead one. Exact for paged KV: attention masks strictly
        by ``[0, pos)``, so the kept write block's tail is dead weight."""
        first = -(-int(pos) // self.block_size)
        for b in range(first, self.n_blocks):
            p = int(self.block_tables[slot, b])
            if p >= 0:
                self._unref(p)
                self.block_tables[slot, b] = -1

    # --------------------------------------------------------------- staging

    def begin_staging(self, pages: list[int]) -> dict:
        """Open the admission stream: matched prefix pages enter its table
        read-only. Returns its batch-1 cache dict over the pool tensors (the
        stream's table and fill in the pool's persistent staging tensors)."""
        self.release_staging()  # defensive: a stale handle leaks pages
        table = np.full((self.n_blocks,), -1, np.int64)
        for i, p in enumerate(pages):
            table[i] = p
            self._ref(p)
        self.staging = _StagingHandle(table=table, fill=len(pages) * self.block_size)
        return self._staging_cache()

    def _staging_cache(self) -> dict:
        h = self.staging
        eff = np.where(h.table >= 0, h.table, DUMMY_PAGE)
        return {"k_pages": self.pages["k_pages"], "v_pages": self.pages["v_pages"],
                "block_table": _upload(self._staging_table_dev, eff[None, :]),
                "pos": _upload(self._staging_pos_dev, [h.fill])}

    def ensure_staging(self, n_tokens: int) -> dict:
        """Page-in the stream's next ``n_tokens`` write blocks from its fill
        and advance the fill by them (the step that follows writes them);
        returns the stream cache with its table and fill refreshed."""
        h = self.staging
        if h is None:
            raise EngineStateError("ensure_staging with no admission stream open")
        off = h.fill
        last = min(off + max(int(n_tokens), 1), self.n_blocks * self.block_size) - 1
        for b in range(off // self.block_size, last // self.block_size + 1):
            if h.table[b] < 0:
                p = self._alloc_page()
                h.table[b] = p
                h.fresh.append(p)
        out = self._staging_cache()
        h.fill = off + int(n_tokens)
        return out

    def release_staging(self) -> None:
        """Abort the admission stream, unpinning every page it references."""
        h = self.staging
        if h is None:
            return
        for p in h.table:
            if p >= 0:
                self._unref(int(p))
        self.staging = None

    # -------------------------------------------------------------- protocol

    def park_staging(self) -> _StagingHandle:
        """Detach the drained stream's handle (batch admission prefills every
        request of a group before inserting any); it keeps its references."""
        h = self.staging
        if h is None:
            raise EngineStateError("park_staging with no admission stream open")
        self.staging = None
        self._parked.append(h)
        return h

    def insert(self, slot: int, handle: Optional[_StagingHandle] = None) -> None:
        """Hand a drained stream's table row (and its refcounts) to ``slot``:
        the open stream's, or a parked ``handle``. The stream wrote its fresh
        pages in place, so nothing is copied."""
        h = self.staging if handle is None else handle
        if h is None:
            raise EngineStateError("paged insert with no staging handle")
        if handle is not None:
            if not any(p is handle for p in self._parked):
                raise EngineStateError("paged insert of a handle that is not parked")
            self._parked = [p for p in self._parked if p is not handle]
        self._drop_row(slot)
        self.block_tables[slot] = h.table
        if handle is None:
            self.staging = None

    def pagify(self, slot: int, src_cache: dict, src_slot: int, pos: int) -> None:
        """Cut lane ``src_slot`` of a contiguous prefill cache (``k`` (nL, B,
        H, hd, Lmax), ``v`` (nL, B, H, Lmax, hd)) into fresh pages for its
        ``ceil(pos / block)`` blocks and give them to ``slot``, as the JAX
        pool's ``_pagify_lane`` does for a batch-prefill admission. The lane
        itself never enters the pool; its blocks move in one copy per leaf."""
        self._drop_row(slot)
        n = min(-(-int(pos) // self.block_size), self.n_blocks)
        if n == 0:
            return
        for i in range(n):
            self.block_tables[slot, i] = self._alloc_page()
        bsz, span = self.block_size, n * self.block_size
        k_lane, v_lane = src_cache["k"][:, src_slot], src_cache["v"][:, src_slot]
        lpad = span - k_lane.shape[-1]
        if lpad > 0:   # a max_len off the block grid: square the lane up to it
            k_lane = torch.nn.functional.pad(k_lane, (0, lpad))
            v_lane = torch.nn.functional.pad(v_lane, (0, 0, 0, lpad))
        nl, h, hd = k_lane.shape[0], k_lane.shape[1], k_lane.shape[2]
        idx = torch.as_tensor(self.block_tables[slot, :n], device=self.device)
        kd = self.pages["k_pages"].dtype
        self.pages["k_pages"][:, idx] = k_lane[..., :span].reshape(
            nl, h, hd, n, bsz).permute(0, 3, 1, 2, 4).to(kd)
        self.pages["v_pages"][:, idx] = v_lane[:, :, :span].reshape(
            nl, h, n, bsz, hd).permute(0, 2, 1, 3, 4).to(kd)

    def retire(self, slot: int) -> None:
        self._drop_row(slot)

    def views(self) -> dict:
        eff = np.where(self.block_tables >= 0, self.block_tables, DUMMY_PAGE)
        return {"k_pages": self.pages["k_pages"], "v_pages": self.pages["v_pages"],
                "block_table": _upload(self._table_dev, eff)}

    def reset_lanes(self) -> None:
        """Drop every lane row, any staging stream and any leaked fork; the
        prefix index and page content survive."""
        self.release_staging()
        for row in list(self._forks):
            self.drop_fork_row(row)
        for h in self._parked:
            for p in h.table:
                if p >= 0:
                    self._unref(int(p))
        self._parked = []
        for slot in range(self.n_slots):
            self._drop_row(slot)

    # ------------------------------------------------------------------ audit

    def audit(self) -> list[str]:
        """Refcounts must be reconstructible from the references themselves."""
        bad: list[str] = []
        expect = np.zeros_like(self.refcount)
        expect[DUMMY_PAGE] += 1
        for row in self.block_tables:
            for p in row:
                if p >= 0:
                    expect[p] += 1
        for h in ([self.staging] if self.staging is not None else []) + self._parked:
            for p in h.table:
                if p >= 0:
                    expect[p] += 1
        for row in self._forks:
            for p in row:
                if p >= 0:
                    expect[p] += 1
        for p in self._index.values():
            expect[p] += 1
        if not (expect == self.refcount).all():
            drift = np.nonzero(expect != self.refcount)[0].tolist()
            bad.append(f"page refcount drift on pages {drift[:8]} "
                       f"(expected from refs != stored)")
        if len(self._free) != len(set(self._free)):
            bad.append("free list contains duplicate pages")
        free = sorted(int(p) for p in self._free)
        zero = sorted(np.nonzero(self.refcount == 0)[0].tolist())
        if free != zero:
            bad.append(f"free list does not equal zero-refcount pages "
                       f"(free={len(free)}, zero-ref={len(zero)})")
        return bad


# ===========================================================================
# the pool
# ===========================================================================


@dataclass
class LaneFork:
    """A point-in-time snapshot of one slot's paged lane: the table row (one
    fork-held ref per page) and the fill level. Spent exactly once, by
    :meth:`CachePool.drop_fork` (accept) or :meth:`CachePool.restore_lane`
    (failure); a second release raises :class:`EngineStateError`."""

    slot: int
    pos: int
    row: np.ndarray
    live: bool = True


@dataclass
class SlotInfo:
    """One decode lane's bookkeeping (owned by the pool, read by the engine)."""

    state: str = FREE
    req: int = -1
    budget: int = 0         # this request's max_new_tokens
    emitted: int = 0
    ctx: int = 0            # prompt length + generated tokens in cache
    reused_tokens: int = 0  # prompt tokens served from the prefix store
    priority: int = 0       # preemption order: lowest-priority slot evicts first


class CachePool:
    """The slot pool: slot table + typed per-family states + admission policy.

    ``alloc``/``insert``/``retire`` do the lane bookkeeping, ``views()`` hands
    the decode step its cache dict (for paged pools: pages + block tables,
    with active lanes' write blocks paged in), ``commit()`` advances the
    fills on the host (free lanes pinned to 0). ``stage_admission`` opens the
    chunk-prefill stream; the prefix index survives :meth:`reset`. Dense KV
    pages unless ``paged=False``; other cache structures (the hybrid's
    Mamba2 states, rwkv6's recurrent state, gemma2's rings beside its global
    lanes, the audio decoder's encoder memory) keep contiguous lanes.

    The fills and block tables live on the host; a step's cache dict holds
    the same device tensors step after step (the fills ``pos``, the block
    tables, a contiguous pool's staging lanes), refreshed in place from the
    host before each step, so a captured step (``core.interleave``) replays
    over fixed addresses and no step reads a fill back from the card.
    """

    def __init__(self, cfg: ModelConfig, max_len: int, n_slots: int, *,
                 prefix_cache: bool = True, block_size: int = 8,
                 prefix_pages: Optional[int] = None, paged: Optional[bool] = None,
                 spec_slack: int = 0, device=None):
        M._check_family(cfg)
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.cfg = cfg
        self.max_len = max_len
        self.n_slots = n_slots
        self.block_size = block_size
        self.prefix_pages = prefix_pages
        # extra per-lane physical blocks for speculative verify transients
        self.spec_slack = max(int(spec_slack), 0)
        self.device = resolve_device(device)
        self.specs = derive_state_specs(cfg)
        self.policy = derive_policy(self.specs)
        # fully paged residency requires KV to be the whole cache state;
        # `paged=False` forces the contiguous A/B path
        pageable = self.policy.prefix_capable
        self.paged = pageable if paged is None else bool(paged) and pageable
        self.prefix_cache = bool(prefix_cache and self.paged)
        self._kv: Optional[PagedKVState] = None
        self.states: list[LaneState] = []
        if self.paged:
            nb = -(-max_len // block_size)
            store_pages = prefix_pages if prefix_pages is not None else 4 * n_slots * nb
            self._kv = PagedKVState(cfg, n_slots, max_len, block_size,
                                    store_pages=store_pages, prefix_cache=self.prefix_cache,
                                    dtype=M.kv_cache_dtype(cfg), device=self.device,
                                    spec_slack=self.spec_slack)
        else:
            cache = M.init_decode_cache(cfg, n_slots, max_len, device=self.device)
            self.states = [LaneState(sp, cache) for sp in self.specs]
        self.stats = {"prefix_lookups": 0, "prefix_hits": 0, "reused_prefix_tokens": 0}
        self._pos_dev = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        # contiguous pools: persistent batch-1 staging caches (the chunk stream
        # takes the first; a batch admission one per request of its group) and
        # their fills on the host
        self._stagings: list[dict] = []
        self._staging_fills: list[int] = []
        self._build()

    @property
    def table_blocks(self) -> int:
        """Blocks in one lane's block table, ``ceil((max_len + spec_slack) /
        block_size)``: the width the paged decode kernels read (0 for a
        contiguous pool)."""
        return self._kv.n_blocks if self._kv is not None else 0

    def _build(self) -> None:
        if self._kv is not None:
            self._kv.reset_lanes()
        for st in self.states:
            st.reset()
        self._pos = np.zeros((self.n_slots,), np.int32)
        self.slots: list[SlotInfo] = [SlotInfo() for _ in range(self.n_slots)]

    def reset(self) -> None:
        """Fresh lanes, slot table and per-drain stats; the prefix index and
        its page content are retained."""
        self._build()
        self.stats = {"prefix_lookups": 0, "prefix_hits": 0, "reused_prefix_tokens": 0}

    # ------------------------------------------------------------ slot table

    def get(self, slot: int) -> SlotInfo:
        return self.slots[slot]

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s.state == FREE]

    def active_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s.state == ACTIVE]

    def has_work(self) -> bool:
        return any(s.state == ACTIVE for s in self.slots)

    # ----------------------------------------------------------- accounting

    def occupancy(self) -> PoolOccupancy:
        kv = self._kv
        if kv is None:
            return PoolOccupancy(slots_total=self.n_slots,
                                 slots_used=len(self.active_slots()),
                                 pages_total=0, pages_used=0, prefix_pins=0)
        indexed = set(kv._index.values())
        pinned = {p for p in indexed if kv.refcount[p] > 1}
        return PoolOccupancy(slots_total=self.n_slots, slots_used=len(self.active_slots()),
                             pages_total=kv.capacity - 1, pages_used=kv.pages_used(),
                             prefix_pins=len(pinned))

    def check_invariants(self) -> list[str]:
        """Audit cache accounting; returns violation descriptions (empty =
        healthy). Live forks are part of the refcount audit, so it holds in
        the middle of a verify round too."""
        bad: list[str] = []
        for i, s in enumerate(self.slots):
            if s.state == FREE and int(self._pos[i]) != 0:
                bad.append(f"free slot {i} has pos={int(self._pos[i])} (expected 0)")
        kv = self._kv
        if kv is None:
            return bad
        bad += kv.audit()
        for i, s in enumerate(self.slots):
            if s.state == FREE and (kv.block_tables[i] >= 0).any():
                bad.append(f"free slot {i} still holds pages "
                           f"{sorted(int(p) for p in kv.block_tables[i] if p >= 0)}")
        return bad

    # -------------------------------------------------------------- protocol

    def alloc(self, request: Any, rid: int, *, reused_tokens: int = 0,
              ctx: Optional[int] = None, emitted: int = 0,
              priority: Optional[int] = None, slot: Optional[int] = None) -> int:
        """Claim the first free lane for ``request`` (a GenerationRequest), or
        the free lane ``slot`` (a speculative draft pool mirrors the target
        pool's slot assignment). A preempted request resumes with ``ctx``
        covering prompt + emitted tokens and ``emitted`` at its emitted count,
        so its budget and RNG lane continue where eviction cut them off. With
        no free lane it raises :class:`PoolExhausted` with the occupancy."""
        free = self.free_slots()
        if slot is not None:
            if self.slots[slot].state != FREE:
                raise EngineStateError(f"CachePool.alloc: slot {slot} is not free")
            si = slot
        elif not free:
            raise PoolExhausted("CachePool.alloc: no free slot", self.occupancy())
        else:
            si = free[0]
        self.slots[si] = SlotInfo(
            state=ACTIVE, req=rid, budget=request.max_new_tokens, emitted=emitted,
            ctx=len(request.prompt) if ctx is None else ctx,
            reused_tokens=reused_tokens,
            priority=getattr(request, "priority", 0) if priority is None else priority)
        return si

    def insert(self, slot: int, prefilled: dict, *, prompt=None, handle=None,
               src_slot: int = 0, fill: Optional[int] = None) -> None:
        """Drop lane ``src_slot`` of a prefilled cache into lane ``slot``. Paged
        pools take the drained admission stream's table row (the open one, or
        a parked ``handle``), or, from a contiguous prefill cache (``k``/``v``
        lanes: a batch-prefill admission), cut the lane into fresh pages; with
        ``prompt`` they harvest its full blocks into the prefix index.
        Contiguous pools copy the lane. ``fill``, where the caller keeps it on
        the host, is the lane's fill (nothing is read back from the cache)."""
        self._pos[slot] = self._fill_of(prefilled, src_slot, handle) if fill is None else fill
        if self._kv is None:
            for st in self.states:
                st.insert(prefilled, slot, src_slot)
            return
        if "k_pages" in prefilled:
            self._kv.insert(slot, handle)
        else:
            try:
                self._kv.pagify(slot, prefilled, src_slot, int(self._pos[slot]))
            except _PagesExhausted as e:
                raise PoolExhausted(str(e), self.occupancy()) from None
        if self.prefix_cache and prompt is not None:
            self._kv.harvest(slot, prompt)

    def _fill_of(self, prefilled: dict, src_slot: int, handle) -> int:
        """The fill of lane ``src_slot`` of a prefilled cache: from the host
        for the pool's own staging (a paged stream's handle, a contiguous
        staging cache), else read from the cache (a prefill's own cache)."""
        if self._kv is not None and "k_pages" in prefilled:
            h = self._kv.staging if handle is None else handle
            if h is None:
                raise EngineStateError("paged insert with no staging handle")
            return h.fill
        for j, st in enumerate(self._stagings):
            if prefilled["pos"] is st["pos"]:
                return self._staging_fills[j]
        fills = prefilled["pos"].reshape(-1)
        return int(fills[src_slot if fills.numel() > 1 else 0])

    def retire(self, slot: int) -> None:
        """Free lane ``slot``: release its pages (paged), zero its recurrent
        state, pin its fill to 0."""
        if self._kv is not None:
            self._kv.retire(slot)
        for st in self.states:
            st.retire(slot)
        self._pos[slot] = 0
        self.slots[slot] = replace(self.slots[slot], state=FREE)

    def views(self, span: int = 1) -> dict:
        """The decode-step cache dict; paged pools page-in every active lane's
        write blocks for the next ``span`` appends (copying a block that a
        fork shares before it is written). The same tensors every call: the
        block tables and fills are written into the pool's persistent ones."""
        kv = self._kv
        out: dict = {}
        if kv is not None:
            try:
                for i, s in enumerate(self.slots):
                    if s.state == ACTIVE:
                        kv.ensure_residency(i, int(self._pos[i]), span)
            except _PagesExhausted as e:
                raise PoolExhausted(str(e), self.occupancy()) from None
            out = kv.views()
        for st in self.states:
            out.update(st.views())
        out["pos"] = _upload(self._pos_dev, self._pos)
        return out

    def commit(self, new_cache: dict) -> None:
        """Absorb a decode step, one token a lane (every cache tensor was
        written in place): every fill advances by one on the host, the values
        the step wrote into ``new_cache["pos"]``, without reading them back.
        Free lanes are pinned back to 0 so their dummy writes stay in the
        dummy page or at column 0."""
        for st in self.states:
            st.commit(new_cache)
        pos = (self._pos + 1).astype(np.int32)
        for i in self.free_slots():
            pos[i] = 0
        self._pos = pos

    # -------------------------------------------------------- fork / rollback

    def _paged(self, what: str) -> PagedKVState:
        if self._kv is None:
            raise EngineStateError(f"{what} requires a paged pool")
        return self._kv

    def fork_lane(self, slot: int) -> LaneFork:
        """Snapshot an active lane before a speculative verify branch writes
        into it: the table row is copied and each page gains one fork-held
        reference; no page content moves. The branch's first append into the
        now shared partial write block copies it first (:meth:`views`)."""
        kv = self._paged("fork_lane")
        if self.slots[slot].state != ACTIVE:
            raise EngineStateError(f"fork_lane of non-active slot {slot}")
        return LaneFork(slot=slot, pos=int(self._pos[slot]), row=kv.fork_row(slot))

    def restore_lane(self, fork: LaneFork) -> None:
        """Reinstate a fork bit-identically (the verify branch failed): the
        branch's pages are released and the snapshot's row and fill level go
        back to the slot. Spends the fork."""
        kv = self._paged("restore_lane")
        if not fork.live:
            raise EngineStateError("restore_lane on a spent fork")
        kv.restore_row(fork.slot, fork.row)
        self._pos[fork.slot] = fork.pos
        fork.live = False

    def drop_fork(self, fork: LaneFork) -> None:
        """Release a fork's page references (the accept path, after
        :meth:`rollback_lane` truncated the lane). Spends the fork."""
        kv = self._paged("drop_fork")
        if not fork.live:
            raise EngineStateError("drop_fork on a spent fork")
        kv.drop_fork_row(fork.row)
        fork.live = False

    def rollback_lane(self, slot: int, pos: int) -> None:
        """Truncate an active lane to fill level ``pos``: blocks at or beyond
        the first dead one are released, each exactly once."""
        self._paged("rollback_lane").rollback(slot, pos)
        self._pos[slot] = int(pos)

    def extract_lane(self, slot: int) -> dict:
        """A batch-1 COPY of one contiguous lane (every leaf's lane, and its
        fill as a (1,) ``pos``). Decode steps write their cache in place, so a
        view would let a draft rollout change the pool before its round
        commits; the copy keeps the pool as it was until :meth:`insert`."""
        return self.extract_lane_into(slot, self.lane_buffers())

    def lane_buffers(self) -> dict:
        """A zeroed batch-1 lane of a contiguous pool: every leaf's lane and a
        (1,) ``pos``, allocated once by a caller that copies lanes into it
        (:meth:`extract_lane_into`) so a captured step replays over it."""
        if self._kv is not None:
            raise EngineStateError("lane buffers require a contiguous pool")
        out = {k: torch.zeros_like(leaf[:, :1]) for st in self.states
               for k, leaf in st.views().items()}
        out["pos"] = torch.zeros((1,), dtype=torch.int32, device=self.device)
        return out

    def extract_lane_into(self, slot: int, lane: dict) -> dict:
        """Copy contiguous lane ``slot`` and its fill into the batch-1
        ``lane`` (:meth:`lane_buffers`), IN PLACE; returns a dict of
        ``lane``'s tensors. The pool is only read."""
        if self._kv is not None:
            raise EngineStateError("extract_lane requires a contiguous pool")
        for st in self.states:
            for k, leaf in st.views().items():
                lane[k].copy_(leaf[:, slot:slot + 1])
        _upload(lane["pos"], [int(self._pos[slot])])
        return dict(lane)

    # ----------------------------------------------------------- admission

    def init_staging(self, index: int = 0) -> dict:
        """The pool's ``index``-th batch-1 CONTIGUOUS admission staging cache,
        zeroed in place, fill 0, as a fresh one would be (non-paged pools;
        paged streams open via :meth:`stage_admission`). The same tensors
        every admission: a captured prefill chunk replays over them."""
        while len(self._stagings) <= index:
            cache = M.init_decode_cache(self.cfg, 1, self.max_len, device=self.device)
            cache["pos"] = cache["pos"].reshape(1).clone()
            self._stagings.append(cache)
            self._staging_fills.append(0)
        cache = self._stagings[index]
        for key, leaf in cache.items():
            if key != "pos":
                leaf.zero_()    # in place
        self._staging_fills[index] = 0
        _upload(cache["pos"], [0])
        return dict(cache)

    def peek_prefix(self, prompt) -> int:
        """Reusable prefix length in tokens — no staging, no stats."""
        if not self.prefix_cache:
            return 0
        return len(self._kv.match_prefix(prompt)) * self._kv.block_size

    def stage_admission(self, prompt) -> tuple[dict, int]:
        """Open the batch-1 admission stream for chunk-prefilling ``prompt``:
        a fresh contiguous staging cache for contiguous pools; for paged pools
        a stream over the pool's pages where, on a prefix hit, the matched
        pages enter its table read-only and the returned ``skip`` tokens are
        not prefilled."""
        kv = self._kv
        if kv is None:
            return self.init_staging(0), 0
        if not self.prefix_cache:
            return kv.begin_staging([]), 0
        self.stats["prefix_lookups"] += 1
        pages = kv.match_prefix(prompt)
        skip = len(pages) * kv.block_size
        if pages:
            self.stats["prefix_hits"] += 1
            self.stats["reused_prefix_tokens"] += skip
        return kv.begin_staging(pages), skip

    def begin_batch_admission(self, index: int = 0) -> dict:
        """Open a staging stream for batch admission (no prefix lookup, no
        stats — the requests it takes had no prefix hit). A contiguous pool
        stages the ``index``-th request of a group in its ``index``-th staging
        cache: the group's lanes are inserted after all of them prefill."""
        if self._kv is None:
            return self.init_staging(index)
        return self._kv.begin_staging([])

    def park_staging(self):
        """Detach the drained stream's handle for a later :meth:`insert`
        (None for contiguous pools: their staging cache is the whole handle)."""
        return None if self._kv is None else self._kv.park_staging()

    def staging_step_prep(self, cache: dict, n_tokens: int) -> dict:
        """Ready the admission stream for a step of ``n_tokens``: page-in its
        next write blocks (paged pools), write its host fill into its ``pos``
        and advance the host fill by them (the step writes them). A
        contiguous cache that is not the pool's staging passes through."""
        if self._kv is None:
            for j, st in enumerate(self._stagings):
                if cache["pos"] is st["pos"]:
                    _upload(st["pos"], [self._staging_fills[j]])
                    self._staging_fills[j] += int(n_tokens)
                    return dict(st)
            return cache
        try:
            return self._kv.ensure_staging(n_tokens)
        except _PagesExhausted as e:
            raise PoolExhausted(str(e), self.occupancy()) from None

    def release_staging(self) -> None:
        """Abort the in-flight admission stream, releasing its pages (no-op
        for contiguous pools)."""
        if self._kv is not None:
            self._kv.release_staging()

    def prefix_report(self) -> dict:
        return {"enabled": self.prefix_cache,
                "block_size": self.block_size if self.prefix_cache else 0,
                "stored_blocks": len(self._kv) if self._kv is not None else 0,
                **self.stats}
