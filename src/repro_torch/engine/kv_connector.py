"""Tiered KV store: a pinned-host tier behind the device page pool, bridged
by a KV connector (the port of ``repro.engine.kv_connector``).

Why
---
The prefix cache (``gateway.prefix_cache``) lives in the device page pool,
so its capacity, and the hit rate it can sustain, is capped by device
memory, and its eviction throws away KV that was expensive to compute. The
host tier turns that eviction into a demotion: a refcount-1 node that
``PrefixCache.evict`` drops first spills its page to host memory (chain
hash kept), and a later trie hit on the same chain reloads it into freshly
allocated pool pages instead of prefilling it again.

Tiers and lifecycle
-------------------
* **spill**: at eviction the victim page is gathered out of the pool
  (``paged_cache.read_pages`` of that one page) and copied to the host
  into a **staging** entry. On a CUDA pool the copy lands in pinned
  memory without blocking: it is queued on the current stream behind every
  kernel that wrote the page and ahead of any that writes it again, and a
  ``torch.cuda.Event`` marks its end. The page can be reused at once. The
  host pages come from chunks of ``CHUNK_PAGES`` pinned pages, and a page
  the tier drops is reused by a later spill: pinning memory costs far more
  than copying into it, so a spill allocates nothing once the tier has
  grown. Until then, a spill that finds no free host page pins a new chunk
  of up to ``CHUNK_PAGES`` pages, and that allocation blocks the host
  until the work queued on the card has finished: an engine's first spills
  stall ``PrefixCache.evict`` inside the admission that evicts, and the
  first time-to-first-token measured behind them includes that stall.
* **flush/commit**: at the top of the next engine step every staged copy's
  event is synchronized and the page goes into the :class:`HostTier`
  store. Only *committed* entries are hittable (``has()``), so an in-flight
  spill can never satisfy a lookup.
* **reload**: admission probes the tier with the chain hashes the device
  trie uses; hits extend ``cached_len`` past the device match, and the
  scheduler records pending reloads into the *fresh* pages it allocated.
  The engine lands them (``paged_cache.write_pages``) before the suffix
  prefill runs. Each bucket's pages (``TRANSFER_BUCKET`` at most) are
  copied from the tier straight into a batch on the pool's device and
  scattered, and the host waits for that
  before the next bucket: the recorded seconds are the whole host-to-device
  leg, and no host page is reused while a copy reads it.

The same two transfers carry the **prefill -> decode handoff** between
engines (``export`` into one pinned buffer per call / ``inject``),
synchronously.

On a CPU pool (the tests) the host copies are plain tensors and nothing is
asynchronous. A pinned allocation that fails raises: the connector never
carries on with pageable memory.

Ranks as processes
------------------
The connector's decisions read only what it is called with: which pages
to spill, flush, reload, export or inject comes from the scheduler and the
prefix cache, and the capacity and the cost model are constants, so they do
not depend on the backend. An engine on rank processes
(``engine.engine``'s module doc) gives every rank a connector of its own,
called in the same order, whose ``read_fn`` is
``paged_cache.read_pages_rank`` (a psum over the SP axes: every rank
receives every page) and whose ``write_fn`` writes each rank's owned
pages. So every rank's host tier holds the same pages, takes the same LRU
and spill decisions and reloads the same bits as the one connector of a
``ThreadMesh`` engine: a tier of B bytes takes B on every rank, P·B of a
host that holds all P ranks. ``stats()`` is per rank, and every rank's
equals the ``ThreadMesh`` engine's: nothing in it is summed over the
ranks (``resident_bytes`` is one rank's copy).

Pricing
-------
``plan.cost.spill_decision`` compares the round-trip transfer bytes with
the chain's recompute FLOPs. The connector spills unconditionally while
the tier has free capacity; under capacity pressure the decision gates
admission. The same cost curve orders ``PrefixCache.evict``'s victims.

A page is a dict ``{'k', 'v'}`` of contiguous tensors (num_layers,
page_size, Hkv, hd); a batch of pages, as ``read_fn`` returns it and
``write_fn`` takes it, stacks them on dim 1, the pool's page axis. The
series are the JAX connector's, under the engine's ``labels`` (the
gateway's ``{replica=i}``), as ``EngineMetrics``'s are.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs

Page = Dict[str, torch.Tensor]

# Host transfers span page-bucket copies (sub-ms) to multi-MB chain
# reloads; pinned so latency quantiles are comparable across runs.
TRANSFER_BUCKETS = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 0.01, 0.03,
                    0.1, 0.3, 1.0, 3.0)
# pages per host-link transfer (reload, export, inject): the unit the
# kv_transfer_seconds series times, as in the JAX engine
TRANSFER_BUCKET = 4
# host pages allocated (and pinned) at once when the free list runs dry
CHUNK_PAGES = 64


@dataclasses.dataclass
class _HostPage:
    """One committed page in the host tier (immutable once stored)."""

    key: int                 # chain hash (position-qualified, trie-equal)
    chain_tokens: int        # tokens of the chain ending at this block
    data: Page               # host tensors (num_layers, ps, Hkv, hd)


@dataclasses.dataclass
class _Staged:
    """An in-flight spill: host tensors whose copy from the card may still
    be running until ``done`` (None on a CPU pool). Invisible to ``has()``
    until committed by ``flush()``."""

    key: int
    chain_tokens: int
    data: Page
    done: Optional[object]   # torch.cuda.Event recorded after the copy
    t0: float                # dispatch time (for the d2h latency sample)


def _stack(pages: Sequence[Page], device) -> Page:
    """One batch (num_layers, len(pages), ps, Hkv, hd) of host ``pages`` in
    order on ``device``: each page is one copy, without blocking from
    pinned memory."""
    out = {}
    for name, first in pages[0].items():
        buf = torch.empty((len(pages),) + tuple(first.shape),
                          dtype=first.dtype, device=device)
        for j, page in enumerate(pages):
            buf[j].copy_(page[name], non_blocking=True)
        out[name] = buf.transpose(0, 1)
    return out


class HostTier:
    """Host page store keyed by chain hash, byte-capacity LRU.

    Holds only *committed* pages; capacity is enforced in whole pages
    (``capacity_bytes // page_bytes``). Eviction is LRU over committed
    entries; reloads touch, so chains in active rotation survive.
    """

    def __init__(self, *, capacity_bytes: int, page_bytes: int,
                 release: Optional[Callable[[_HostPage], None]] = None):
        if page_bytes <= 0:
            raise ValueError(f"page_bytes must be positive, got {page_bytes}")
        self.page_bytes = page_bytes
        self.capacity_pages = max(int(capacity_bytes) // page_bytes, 0)
        self._store: "collections.OrderedDict[int, _HostPage]" = \
            collections.OrderedDict()
        self.evicted_pages = 0
        # called with every page the tier drops (its buffers are reused)
        self.release = release

    def __len__(self) -> int:
        return len(self._store)

    @property
    def bytes_resident(self) -> int:
        return len(self._store) * self.page_bytes

    def has(self, key: int) -> bool:
        """Pure membership probe: no LRU touch (blocked admissions must
        stay side-effect free)."""
        return key in self._store

    def get(self, key: int) -> _HostPage:
        entry = self._store[key]
        self._store.move_to_end(key)
        return entry

    def touch(self, key: int) -> None:
        if key in self._store:
            self._store.move_to_end(key)

    def put(self, entry: _HostPage) -> int:
        """Insert (or LRU-touch) a committed page; evicts LRU entries past
        capacity. Returns the number of host pages evicted."""
        if entry.key in self._store:
            self._store.move_to_end(entry.key)
            self._drop(entry)                    # its buffers go unused
            return 0
        self._store[entry.key] = entry
        dropped = 0
        while len(self._store) > self.capacity_pages:
            self._drop(self._store.popitem(last=False)[1])
            dropped += 1
        self.evicted_pages += dropped
        return dropped

    def drop_all(self) -> None:
        for entry in self._store.values():
            self._drop(entry)
        self._store.clear()

    def _drop(self, entry: _HostPage) -> None:
        if self.release is not None:
            self.release(entry)


class KVConnector:
    """Bridge between one engine's page pool and its host tier.

    The engine supplies the two transfers:

    * ``read_fn(idx)``: (n,) int64 global page ids, n <= ``bucket`` -> a
      batch of pages, tensors (num_layers, n, ps, Hkv, hd) on the pool's
      device;
    * ``write_fn(idx, data)``: scatter such a batch (on the pool's device)
      back into the pools, in place.

    Global page id = ``shard * pages_per_shard + local_page``, the SP shard
    order, so one integer round-trips through the host tier and lands on
    the owning shard. ``device`` is the pool's: on a CUDA pool the host
    copies live in pinned memory and copy without blocking (module doc).
    """

    def __init__(self, *, read_fn: Callable, write_fn: Callable,
                 bucket: int, page_size: int, pages_per_shard: int,
                 page_bytes: int, capacity_bytes: int,
                 spill_fn: Optional[Callable[[int], bool]] = None,
                 registry: Optional[obs.Registry] = None,
                 labels: Optional[Dict[str, str]] = None,
                 device=torch.device("cpu")):
        self.read_fn = read_fn
        self.write_fn = write_fn
        self.bucket = bucket
        self.page_size = page_size
        self.pages_per_shard = pages_per_shard
        self.page_bytes = page_bytes
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        self._free: List[Page] = []        # host page buffers to reuse
        self.tier = HostTier(capacity_bytes=capacity_bytes,
                             page_bytes=page_bytes,
                             release=lambda e: self._free.append(e.data))
        # spill_fn(chain_tokens) -> True when the transfer round trip beats
        # recompute (plan.cost.spill_decision); consulted only under
        # capacity pressure: free host capacity always admits
        self.spill_fn = spill_fn
        self._staging: Dict[int, List[_Staged]] = {}     # per source shard
        self._staged_keys: set = set()
        self.registry = registry if registry is not None else obs.Registry()
        self.labels = dict(labels or {})
        r = self.registry
        self._pages = r.counter(
            "kv_transfer_pages_total",
            "KV pages moved over the host link, by op "
            "(spill/reload/handoff_out/handoff_in)")
        self._bytes = r.counter(
            "kv_transfer_bytes_total", "KV bytes moved over the host link")
        self._lat = r.histogram(
            "kv_transfer_seconds",
            "Host-observed transfer latency (dispatch -> commit for "
            "spills; host assembly, copy and scatter for reloads)",
            buckets=TRANSFER_BUCKETS)
        self._skipped = r.counter(
            "host_tier_spill_skipped_total",
            "Spills refused by the cost model under capacity pressure")
        self._host_evict = r.counter(
            "host_tier_evicted_pages_total", "Host-tier LRU evictions")
        self._hit_tok = r.counter(
            "host_tier_hit_tokens_total",
            "Prompt tokens served from the host tier")
        self._lookup_tok = r.counter(
            "host_tier_lookup_tokens_total",
            "Prompt tokens probed against the host tier (past the "
            "device-trie match)")
        self._g_pages = r.gauge("host_tier_pages",
                                "Committed pages resident in the host tier")
        self._g_bytes = r.gauge("host_tier_bytes",
                                "Committed bytes resident in the host tier")
        self._g_hit = r.gauge("host_tier_hit_rate",
                              "host hit tokens / host lookup tokens")

    # ---- helpers --------------------------------------------------------
    def global_id(self, page: Tuple[int, int]) -> int:
        shard, local = page
        return shard * self.pages_per_shard + local

    def _ids(self, pages: Sequence[Tuple[int, int]]) -> np.ndarray:
        """The global ids of ``pages`` (one transfer's, unpadded)."""
        return np.array([self.global_id(p) for p in pages], np.int64)

    def _host_page(self, like: Page) -> Page:
        """A host page shaped like ``like``'s pages: a reused one, else one
        of a new chunk of ``CHUNK_PAGES`` allocated (and pinned) at once."""
        if not self._free:
            n = min(CHUNK_PAGES, max(self.tier.capacity_pages, 1))
            chunk = {name: torch.empty((n,) + tuple(t.shape[:1] + t.shape[2:]),
                                       dtype=t.dtype, pin_memory=self.pinned)
                     for name, t in like.items()}
            self._free.extend({name: c[i] for name, c in chunk.items()}
                              for i in range(n))
        return self._free.pop()

    def _wait(self) -> None:
        """Block until the queued copies have landed (a CUDA pool)."""
        if self.pinned:
            torch.cuda.current_stream().synchronize()

    def _count(self, op: str, pages: int, seconds: float) -> None:
        self._pages.inc(pages, op=op, **self.labels)
        self._bytes.inc(pages * self.page_bytes, op=op, **self.labels)
        self._lat.observe(seconds, op=op, **self.labels)

    @property
    def enabled(self) -> bool:
        return self.tier.capacity_pages > 0

    # ---- spill (device -> staging -> host) ------------------------------
    def spill(self, *, key: int, page: Tuple[int, int],
              chain_tokens: int) -> bool:
        """Stage an evicted page for the host tier. Called by
        ``PrefixCache.evict`` *before* the pool reference drops: the read
        and its copy are queued here, so the page's value is captured in
        stream order even though the page may be reallocated within the
        same admission. Returns True when a copy was staged."""
        if not self.enabled:
            return False
        if self.tier.has(key):
            self.tier.touch(key)                 # dedupe: already resident
            return False
        if key in self._staged_keys:
            return False
        occupied = len(self.tier) + len(self._staged_keys)
        if occupied >= self.tier.capacity_pages and self.spill_fn is not None \
                and not self.spill_fn(chain_tokens):
            self._skipped.inc(1, **self.labels)
            return False
        out = self.read_fn(self._ids([page]))
        data = self._host_page(out)
        for n, t in out.items():
            data[n].copy_(t[:, 0], non_blocking=True)
        done = None
        if self.pinned:
            done = torch.cuda.Event()
            done.record()
        self._staging.setdefault(page[0], []).append(
            _Staged(key=key, chain_tokens=chain_tokens, data=data, done=done,
                    t0=time.perf_counter()))
        self._staged_keys.add(key)
        return True

    def flush(self) -> int:
        """Commit every staged spill: wait for its copy, move the page into
        the host store, and only then make it hittable. Called once per
        engine step: a crash or reset mid-flight loses staged pages, never
        corrupts committed ones."""
        committed = 0
        for shard in sorted(self._staging):
            for entry in self._staging[shard]:
                if entry.done is not None:
                    entry.done.synchronize()
                self._count("spill", 1, time.perf_counter() - entry.t0)
                dropped = self.tier.put(_HostPage(
                    key=entry.key, chain_tokens=entry.chain_tokens,
                    data=entry.data))
                if dropped:
                    self._host_evict.inc(dropped, **self.labels)
                committed += 1
        self._staging.clear()
        self._staged_keys.clear()
        self._update_gauges()
        return committed

    # ---- lookup / reload (host -> device) -------------------------------
    def has(self, key: int) -> bool:
        """Committed-only membership (staged spills are not hittable).
        Pure: safe on blocked admissions."""
        return self.tier.has(key)

    def note_probe(self, lookup_blocks: int, hit_blocks: int) -> None:
        """Hit-rate accounting, called once per *successful* admission
        (blocked admissions leave no trace)."""
        self._lookup_tok.inc(lookup_blocks * self.page_size, **self.labels)
        self._hit_tok.inc(hit_blocks * self.page_size, **self.labels)
        self._update_gauges()

    def reload(self, items: Sequence[Tuple[int, Tuple[int, int]]]) -> None:
        """Write committed host pages into freshly allocated pool pages.

        items: (chain hash, (shard, local page)) per block, in block order.
        The entries stay resident in the tier (LRU-touched): other
        arrivals of the same chain may need them again after the fresh
        copies are themselves evicted.
        """
        if not items:
            return
        for lo in range(0, len(items), self.bucket):
            batch = items[lo:lo + self.bucket]
            t0 = time.perf_counter()
            entries = []
            for key, _ in batch:
                if not self.tier.has(key):
                    raise RuntimeError(
                        f"host-tier reload of missing chain hash {key:#x} "
                        "(evicted between admission and reload?)")
                entries.append(self.tier.get(key))
            self.write_fn(self._ids([page for _, page in batch]),
                          _stack([e.data for e in entries], self.device))
            self._wait()
            self._count("reload", len(batch), time.perf_counter() - t0)
        self._update_gauges()

    # ---- prefill -> decode handoff --------------------------------------
    def export(self, pages: Sequence[Tuple[int, int]]) -> List[Page]:
        """Read whole pages to the host (synchronous) for a handoff to
        another engine. Returns one page per entry of ``pages``, in order.
        The pages are not inserted into this tier: they belong to the
        receiving engine."""
        host: Page = {}
        for lo in range(0, len(pages), self.bucket):
            batch = pages[lo:lo + self.bucket]
            t0 = time.perf_counter()
            dev = self.read_fn(self._ids(batch))
            for n, t in dev.items():
                if n not in host:       # one buffer for the whole export
                    host[n] = torch.empty(
                        (len(pages),) + tuple(t.shape[:1] + t.shape[2:]),
                        dtype=t.dtype, pin_memory=self.pinned)
                host[n][lo:lo + len(batch)].copy_(t.transpose(0, 1),
                                                  non_blocking=True)
            self._wait()
            self._count("handoff_out", len(batch),
                        time.perf_counter() - t0)
        return [{n: t[j] for n, t in host.items()}
                for j in range(len(pages))]

    def inject(self, pages: Sequence[Tuple[int, int]],
               blocks: Sequence[Page]) -> None:
        """Write exported pages (from a peer connector's ``export``) into
        this engine's pool pages, block order matching ``pages``."""
        if len(pages) != len(blocks):
            raise ValueError(f"{len(blocks)} blocks for {len(pages)} pages")
        for lo in range(0, len(pages), self.bucket):
            bp = pages[lo:lo + self.bucket]
            t0 = time.perf_counter()
            self.write_fn(self._ids(bp),
                          _stack(blocks[lo:lo + self.bucket], self.device))
            self._wait()
            self._count("handoff_in", len(bp), time.perf_counter() - t0)

    # ---- lifecycle / stats ----------------------------------------------
    def reset(self) -> None:
        """Engine reset: drop committed and staged pages and zero the
        tier-level series (the transfer counters follow ``EngineMetrics``'
        reset convention)."""
        self.tier.drop_all()
        self.tier.evicted_pages = 0
        self._free.extend(e.data for es in self._staging.values() for e in es)
        self._staging.clear()
        self._staged_keys.clear()
        for op in ("spill", "reload", "handoff_out", "handoff_in"):
            self._pages.set(0, op=op, **self.labels)
            self._bytes.set(0, op=op, **self.labels)
            self._lat.reset(op=op, **self.labels)
        for c in (self._skipped, self._host_evict, self._hit_tok,
                  self._lookup_tok):
            c.set(0, **self.labels)
        self._update_gauges()

    def _update_gauges(self) -> None:
        self._g_pages.set(len(self.tier), **self.labels)
        self._g_bytes.set(self.tier.bytes_resident, **self.labels)
        self._g_hit.set(self.hit_rate, **self.labels)

    @property
    def hit_rate(self) -> float:
        lookup = self._lookup_tok.value(**self.labels)
        return (self._hit_tok.value(**self.labels) / lookup if lookup
                else 0.0)

    def stats(self) -> Dict[str, float]:
        v = self.labels
        return {
            "capacity_pages": self.tier.capacity_pages,
            "resident_pages": len(self.tier),
            "resident_bytes": self.tier.bytes_resident,
            "staged_pages": len(self._staged_keys),
            "spill_pages": int(self._pages.value(op="spill", **v)),
            "spill_bytes": int(self._bytes.value(op="spill", **v)),
            "reload_pages": int(self._pages.value(op="reload", **v)),
            "reload_bytes": int(self._bytes.value(op="reload", **v)),
            "handoff_out_pages": int(self._pages.value(op="handoff_out",
                                                       **v)),
            "handoff_in_pages": int(self._pages.value(op="handoff_in", **v)),
            "spills_skipped": int(self._skipped.value(**v)),
            "host_evicted_pages": int(self._host_evict.value(**v)),
            "hit_tokens": int(self._hit_tok.value(**v)),
            "lookup_tokens": int(self._lookup_tok.value(**v)),
            "hit_rate": self.hit_rate,
        }
