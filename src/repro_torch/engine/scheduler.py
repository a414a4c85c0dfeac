"""Continuous-batching scheduler: FIFO admission, slot reuse, paged
allocation, eviction on completion (JetStream-style driver state, adapted
to the round-robin SP page layout of ``engine.paged_cache``).

All state here is host-side numpy/python; the device sees only the page
*table* and per-slot scalars the engine assembles each step. This is the
port's copy of ``repro.engine.scheduler``; the engine sets the prefix-cache
hook (``repro_torch.gateway.prefix_cache``) when its plan asks for it, and
always the KV connector (``repro_torch.engine.kv_connector``), whose host
tier admission probes past the device-trie match when the tier is on.

Policy
------
* **FIFO admission with head-of-line blocking**: requests are admitted in
  arrival order; if the head request does not fit (no free slot, or a shard
  lacks free pages) nothing behind it is admitted. Simple and starvation-free.
* **Worst-case reservation**: a request's pages for ``prompt_len +
  max_new_tokens`` positions are allocated at admission, so decode can never
  stall mid-generation. (Lazy growth + preemption à la vLLM is a possible
  refinement; the page-table plumbing already supports it.)
* **Round-robin block placement**: logical block ``b`` goes to SP shard
  ``b % P_sp`` — per-shard load for any single sequence is balanced to
  within one page, keeping per-device decode compute flat in ``P_sp``.
* **Ref-counted pages / prefix reuse**: every page lifecycle event goes
  through ``paged_cache.PagePool`` (never a raw free-list append). With a
  ``gateway.prefix_cache.PrefixCache`` attached, admission matches
  the request's full prompt blocks against the block-hash trie, *shares*
  the hit pages (incref, no copy), and reserves fresh pages only for the
  uncached suffix — ``SlotState.cached_len`` tells the engine how many
  leading prompt tokens to skip at prefill.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.engine.paged_cache import PagePool


@dataclasses.dataclass
class Request:
    """One serving request (sampling follows ``engine.sampling``)."""

    uid: str
    tokens: List[int]                  # prompt token ids
    max_new_tokens: int
    temperature: float = 0.0           # <= 0 -> greedy
    top_k: int = 0                     # 0 disables
    top_p: float = 1.0                 # 1.0 disables
    seed: int = 0
    handoff: bool = False              # prefill-role request: stop after the
    #                                    first token and keep the prompt KV
    #                                    live until the gateway exports it to
    #                                    a decode replica
    priority: str = "batch"            # frontend priority class name; the
    #                                    engine itself is priority-blind

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)


@dataclasses.dataclass(frozen=True)
class Rejection:
    """Typed admission failure.

    ``reason`` is a stable machine-readable slug (one per failure mode so
    the HTTP layer can map it to a status code), ``detail`` the human
    string, and ``retry_after_steps`` an engine-step hint for when retrying
    could succeed — ``None`` means the request can never be admitted as-is
    (a client error, not back-pressure).
    """

    reason: str
    detail: str = ""
    retry_after_steps: Optional[int] = None

    @property
    def retryable(self) -> bool:
        return self.retry_after_steps is not None


@dataclasses.dataclass
class SlotState:
    req: Request
    slot: int
    arrived_step: int
    cache_len: int = 0                 # filled KV positions
    cached_len: int = 0                # leading prompt tokens from the prefix
    #                                    cache (multiple of page_size); the
    #                                    engine prefills only the suffix
    prefill_pos: int = 0               # prompt tokens whose KV has landed in
    #                                    pool pages (chunked prefill cursor;
    #                                    starts at cached_len, reaches
    #                                    prompt_len when prefill completes)
    host_len: int = 0                  # of cached_len, tokens whose blocks
    #                                    are host-tier hits: their KV must be
    #                                    reloaded into the fresh pages listed
    #                                    in pending_reload before any forward
    out: List[int] = dataclasses.field(default_factory=list)
    pages: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    hashes: List[int] = dataclasses.field(default_factory=list)
    # (chain hash, (shard, local page)) per host-hit block, block order
    pending_reload: List[Tuple[int, Tuple[int, int]]] = \
        dataclasses.field(default_factory=list)
    first_token_step: Optional[int] = None
    done_step: Optional[int] = None

    @property
    def done(self) -> bool:
        return len(self.out) >= self.req.max_new_tokens


def bucket_pow2(n: int, lo: int = 1) -> int:
    """Smallest lo * 2^i >= n (length-bucketed compilation)."""
    b = lo
    while b < n:
        b *= 2
    return b


class Scheduler:
    def __init__(self, *, max_slots: int, page_size: int, sp: int,
                 pages_per_shard: int, max_len: int, prefix_cache=None):
        if max_len % page_size:
            max_len = (max_len // page_size + 1) * page_size
        self.max_slots = max_slots
        self.page_size = page_size
        self.sp = sp
        self.pages_per_shard = pages_per_shard
        self.max_len = max_len
        self.max_blocks = math.ceil(max_len / page_size)
        self.table_width = math.ceil(self.max_blocks / sp)
        self.queue: Deque[Request] = collections.deque()
        self.slots: List[Optional[SlotState]] = [None] * max_slots
        self.pool = PagePool(sp, pages_per_shard)
        # optional gateway.prefix_cache.PrefixCache sharing this pool
        self.prefix_cache = prefix_cache
        # optional engine.kv_connector.KVConnector: admission probes
        # its committed host tier for blocks past the device-trie match
        self.connector = None
        # disaggregated handoff inbox: (req, first token, exported KV
        # blocks) injected by the gateway, admitted like prefills but
        # skipping the forward entirely
        self.prefilled: Deque[Tuple[Request, int, list]] = collections.deque()
        self.table = np.full((max_slots, sp, self.table_width), -1, np.int32)
        self.finished: Dict[str, SlotState] = {}

    # ---- queue ----------------------------------------------------------
    def validate(self, req: Request) -> Optional[Rejection]:
        """Read-only admission probe: the :class:`Rejection` this request
        would draw, or ``None`` if it is serveable. All four reasons are
        permanent (``retry_after_steps=None``): they depend only on the
        request shape and the engine geometry, never on load."""
        if req.prompt_len < 1:
            return Rejection("empty_prompt", f"{req.uid}: empty prompt")
        if req.max_new_tokens < 1:
            return Rejection(
                "bad_budget", f"{req.uid}: max_new_tokens must be >= 1")
        if req.prompt_len + req.max_new_tokens > self.max_len:
            return Rejection(
                "too_long",
                f"{req.uid}: prompt {req.prompt_len} + budget "
                f"{req.max_new_tokens} exceeds engine max_len {self.max_len}")
        worst = max(self._per_shard_need(self._blocks_for(req)))
        if worst > self.pages_per_shard:
            return Rejection(
                "pool_too_small",
                f"{req.uid}: needs {worst} pages on a shard but the pool "
                f"holds {self.pages_per_shard}/shard — raise pages_per_shard "
                f"or shrink the request")
        return None

    def enqueue(self, req: Request) -> None:
        rej = self.validate(req)
        if rej is not None:
            raise ValueError(rej.detail)
        self.queue.append(req)

    # ---- paging ---------------------------------------------------------
    def _blocks_for(self, req: Request) -> int:
        return math.ceil((req.prompt_len + req.max_new_tokens)
                         / self.page_size)

    def _per_shard_need(self, nb: int) -> List[int]:
        """Pages shard s must supply for blocks 0..nb-1 (round-robin)."""
        return [nb // self.sp + (1 if s < nb % self.sp else 0)
                for s in range(self.sp)]

    def pages_in_use(self) -> int:
        return self.pool.pages_in_use()

    def pages_total(self) -> int:
        return self.pool.pages_total()

    # ---- admission / eviction ------------------------------------------
    def _alloc_evicting(self, shard: int) -> int:
        """Pop a free page on ``shard``, evicting cache-only pages if dry.
        Only called after :meth:`admit`'s feasibility check, so a dry pool
        here is a bookkeeping bug, not back-pressure."""
        if self.pool.available(shard) == 0 and self.prefix_cache is not None:
            self.prefix_cache.evict(shard, 1)
        if self.pool.available(shard) == 0:
            raise RuntimeError(
                f"shard {shard} dry after a feasible admission check")
        return self.pool.alloc(shard)

    def admit(self, step: int, limit: Optional[int] = None
              ) -> List[SlotState]:
        """FIFO-admit queued requests into free slots while pages last.

        With a prefix cache attached, the head request's full prompt blocks
        are matched first: hit pages are shared (incref — the cached KV is
        reused in place) and only the uncached suffix allocates fresh
        pages, evicting least-recently-used cache-only pages under
        pressure. Feasibility (free + evictable pages per shard) is checked
        *before* anything destructive: a head request that cannot get its
        suffix pages blocks without evicting a single cached block, without
        touching LRU stamps, and without skewing hit-rate stats — the probe
        is read-only until admission is certain.

        ``limit`` caps the admissions per call: the engine admits one at a
        time so a burst of shared-prefix arrivals hits the blocks the
        previous admission's prefill registered moments earlier.
        """
        admitted = []
        while self.queue and (limit is None or len(admitted) < limit):
            free_slot = next(
                (i for i, s in enumerate(self.slots) if s is None), None)
            if free_slot is None:
                break
            req = self.queue[0]
            nb = self._blocks_for(req)
            hashes: List[int] = []
            matched: List[Tuple[int, int]] = []
            host_hits: List[int] = []
            usable = 0
            if self.prefix_cache is not None:
                # all full prompt blocks (register_prefix inserts them)...
                hashes = self.prefix_cache.hashes(req.tokens)
                # ...but match at most (prompt_len - 1) // ps of them:
                # the next-token hidden state is not cached, so a fully-
                # cached prompt still forwards its final token through
                # the suffix prefill
                usable = (req.prompt_len - 1) // self.page_size
                matched = self.prefix_cache.match(hashes[:usable])
                if self.connector is not None and self.connector.enabled:
                    # host-tier hits extend the cached prefix past the
                    # device match — cheap (no recompute) but not free:
                    # they still need fresh pages, so they stay in `need`
                    # and the feasibility check below counts them like
                    # any uncached block. `has` is pure: a blocked
                    # admission leaves no trace in either tier.
                    b = len(matched)
                    while b < usable and self.connector.has(hashes[b]):
                        host_hits.append(hashes[b])
                        b += 1
            n_hits = len(matched)
            need = [0] * self.sp
            for b in range(n_hits, nb):
                need[b % self.sp] += 1
            # the hit pages are about to gain a live ref, so they must not
            # count as evictable capacity (exclude=matched)
            evictable = (self.prefix_cache.evictable_counts(
                self.sp, exclude=matched)
                if self.prefix_cache is not None else [0] * self.sp)
            if any(self.pool.available(s) + evictable[s] < need[s]
                   for s in range(self.sp)):
                break                                       # head-of-line
            hits: List[Tuple[int, int]] = []
            if self.prefix_cache is not None:
                hits = self.prefix_cache.acquire(
                    hashes[:usable])                        # increfs+stats
                assert hits == matched
            fresh = [(b % self.sp, self._alloc_evicting(b % self.sp))
                     for b in range(n_hits, nb)]
            self.queue.popleft()
            cached = (n_hits + len(host_hits)) * self.page_size
            st = SlotState(req=req, slot=free_slot, arrived_step=step,
                           cached_len=cached, prefill_pos=cached,
                           host_len=len(host_hits) * self.page_size,
                           hashes=hashes)
            # host-hit block b maps to fresh[b - n_hits]: the engine
            # reloads its KV there before the suffix prefill runs
            st.pending_reload = [(h, fresh[j])
                                 for j, h in enumerate(host_hits)]
            if self.connector is not None and self.connector.enabled \
                    and usable > n_hits:
                self.connector.note_probe(usable - n_hits, len(host_hits))
            st.pages = hits + fresh
            for b, (shard, page) in enumerate(st.pages):
                self.table[free_slot, shard, b // self.sp] = page
            self.slots[free_slot] = st
            admitted.append(st)
        return admitted

    # ---- disaggregated handoff (decode-role replicas) -------------------
    def enqueue_prefilled(self, req: Request, first_token: int,
                          blocks: list) -> None:
        """Queue a request whose prompt KV was prefilled on another
        replica: ``blocks`` are the exported page trees (one per block of
        ``ceil(prompt_len / page_size)``), ``first_token`` the token the
        prefill replica already sampled and emitted."""
        if req.prompt_len < 1:
            raise ValueError(f"{req.uid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"{req.uid}: max_new_tokens must be >= 1")
        if req.prompt_len + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"{req.uid}: prompt {req.prompt_len} + budget "
                f"{req.max_new_tokens} exceeds engine max_len {self.max_len}")
        nb_kv = math.ceil(req.prompt_len / self.page_size)
        if len(blocks) != nb_kv:
            raise ValueError(
                f"{req.uid}: handoff carries {len(blocks)} KV blocks, "
                f"prompt needs {nb_kv}")
        worst = max(self._per_shard_need(self._blocks_for(req)))
        if worst > self.pages_per_shard:
            raise ValueError(
                f"{req.uid}: needs {worst} pages on a shard but the pool "
                f"holds {self.pages_per_shard}/shard")
        self.prefilled.append((req, first_token, blocks))

    def admit_prefilled(self, step: int, limit: Optional[int] = None
                        ) -> List[Tuple[SlotState, int, list]]:
        """FIFO-admit handed-off requests into free slots. Every block
        allocates fresh pages (an injected prompt never shares the trie —
        its KV arrives from outside the pool), with the same read-only
        feasibility check as :meth:`admit`. The caller (the engine) must
        inject the returned blocks into the slot's pages before the next
        decode step."""
        out: List[Tuple[SlotState, int, list]] = []
        while self.prefilled and (limit is None or len(out) < limit):
            free_slot = next(
                (i for i, s in enumerate(self.slots) if s is None), None)
            if free_slot is None:
                break
            req, tok, blocks = self.prefilled[0]
            nb = self._blocks_for(req)
            need = self._per_shard_need(nb)
            evictable = (self.prefix_cache.evictable_counts(self.sp)
                         if self.prefix_cache is not None else [0] * self.sp)
            if any(self.pool.available(s) + evictable[s] < need[s]
                   for s in range(self.sp)):
                break                                       # head-of-line
            fresh = [(b % self.sp, self._alloc_evicting(b % self.sp))
                     for b in range(nb)]
            self.prefilled.popleft()
            st = SlotState(req=req, slot=free_slot, arrived_step=step)
            st.pages = fresh
            for b, (shard, page) in enumerate(st.pages):
                self.table[free_slot, shard, b // self.sp] = page
            self.slots[free_slot] = st
            out.append((st, tok, blocks))
        return out

    def register_prefix(self, st: SlotState) -> None:
        """Offer a freshly prefilled request's full prompt blocks to the
        prefix cache (the engine calls this right after the prefill+insert
        lands, when the pages hold valid KV). No-op without a cache."""
        if self.prefix_cache is None:
            return
        full = st.req.prompt_len // self.page_size
        self.prefix_cache.insert(st.hashes[:full], st.pages[:full])

    def finish(self, slot: int, step: int) -> SlotState:
        st = self.slots[slot]
        assert st is not None
        for shard, page in st.pages:
            self.pool.decref(shard, page)   # shared pages may stay cached
        st.pages = []
        st.done_step = step
        self.table[slot] = -1
        self.slots[slot] = None
        self.finished[st.req.uid] = st
        return st

    # ---- decode batch shape --------------------------------------------
    def active(self) -> List[SlotState]:
        return [s for s in self.slots if s is not None]

    def decode_width(self) -> int:
        """Bucketed per-shard table width for the current decode batch: the
        write at position cache_len needs blocks 0..cache_len//ps, i.e.
        ceil((cache_len//ps + 1) / sp) local blocks."""
        need = 1
        for st in self.active():
            blocks = st.cache_len // self.page_size + 1
            need = max(need, math.ceil(blocks / self.sp))
        return min(bucket_pow2(need), self.table_width)
