"""Block-hash prefix cache: copy-on-write KV reuse over the paged pool (the
port's copy of ``repro.gateway.prefix_cache``, which imports no JAX).

The cache is a trie over *full prompt pages*. A node is one logical block
of ``page_size`` tokens, keyed by the chain hash

    h_0 = H(seed, tokens[0:ps])          h_b = H(h_{b-1}, tokens[b*ps:(b+1)*ps])

so equal hashes mean equal *prefixes*, not just equal blocks (the vLLM
automatic-prefix-caching construction). Each node pins one physical page
``(shard, local_page)`` in the engine's SP-sharded pool — block ``b`` lives
on shard ``b % P_sp``, so a node at depth ``b`` always names a page on that
shard and a trie hit reuses the exact round-robin layout the decode step
expects.

Reference counting (``paged_cache.PagePool``) carries the copy-on-write
semantics: the cache holds one reference per retained node, every live
request sharing the block holds another, and a page is recycled only when
the last holder lets go. Shared pages are immutable by construction —
decode writes land strictly past the full-prompt prefix — so "copy" never
actually happens; what COW buys here is that **eviction can never corrupt a
live request**: evicting a node only drops the cache's reference, and the
page body survives until the last sharing request finishes.

Eviction is leaf-first and cost-aware: only nodes with no children and no
live sharer (refcount == 1, the cache's own hold) are candidates, so an
interior node is never dropped while a descendant could still be matched
through it. Candidates are ranked by the recompute cost a future miss on
their chain would pay (``cost_fn`` over tokens-in-chain: the engine passes
``plan.cost.prefill_step_cost``; the default is the token count itself,
the same order for any cost that grows with the tokens), with the LRU
stamp as the tie-break, so an expensive deep chain outlives a cheap
shallow one that happens to be more recent. When a ``connector``
(``engine.kv_connector.KVConnector``) is attached, every dropped node's
page is offered to the pinned-host tier first: eviction then demotes KV
instead of destroying it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_HASH_SEED = 0x51ab5eed


def block_hashes(tokens: Sequence[int], page_size: int) -> List[int]:
    """Chain hashes of the *full* blocks of ``tokens`` (partial tail block
    excluded — its page is mutable until decode passes it, so it is never
    shared)."""
    out: List[int] = []
    prev = _HASH_SEED
    for b in range(len(tokens) // page_size):
        prev = hash((prev, tuple(tokens[b * page_size:(b + 1) * page_size])))
        out.append(prev)
    return out


@dataclasses.dataclass
class _Node:
    key: int                            # chain hash (position-qualified)
    page: Tuple[int, int]               # (shard, local page id) in the pool
    parent: Optional["_Node"]
    children: Dict[int, "_Node"] = dataclasses.field(default_factory=dict)
    stamp: int = 0                      # LRU clock tick of the last touch


class PrefixCache:
    """Trie of cached full prompt blocks over one engine's page pool."""

    def __init__(self, pool, *, page_size: int, sp: int,
                 cost_fn: Optional[Callable[[int], float]] = None,
                 connector=None):
        self.pool = pool                # paged_cache.PagePool (shared with
        #                                 the scheduler: same refcounts)
        self.page_size = page_size
        self.sp = sp
        # cost_fn(chain_tokens) -> relative recompute cost of losing a node
        # at that chain depth; tokens themselves are the default
        self.cost_fn = cost_fn or float
        self.connector = connector      # engine.kv_connector.KVConnector
        self.children: Dict[int, _Node] = {}     # root level
        self._clock = 0
        # metrics (token-denominated where it matters for hit rate)
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.evicted_pages = 0
        self.inserted_pages = 0

    def hashes(self, tokens: Sequence[int]) -> List[int]:
        return block_hashes(tokens, self.page_size)

    # ---- lookup ---------------------------------------------------------
    def _walk(self, hashes: Sequence[int]) -> List[_Node]:
        nodes: List[_Node] = []
        level = self.children
        for h in hashes:
            node = level.get(h)
            if node is None:
                break
            nodes.append(node)
            level = node.children
        return nodes

    def match_len(self, hashes: Sequence[int]) -> int:
        """Longest cached prefix, in blocks. Read-only (the router's
        probe)."""
        return len(self._walk(hashes))

    def match(self, hashes: Sequence[int]) -> List[Tuple[int, int]]:
        """The longest cached prefix's pages, in block order. Read-only —
        no refcounts, stats or LRU stamps move (the scheduler probes with
        this before it knows whether admission is feasible)."""
        return [node.page for node in self._walk(hashes)]

    def evictable_counts(self, sp: int,
                         exclude: Sequence[Tuple[int, int]] = ()
                         ) -> List[int]:
        """Per-shard count of pages eviction could free right now:
        cache-only holds (refcount 1 — a live sharer implies every
        ancestor is live too, so a refcount-1 node's whole subtree is
        cache-only and reachable leaf-first). ``exclude`` masks pages
        about to gain a live ref (the admission's own prefix hits)."""
        out = [0] * sp
        ex = set(tuple(p) for p in exclude)
        for node in self._iter_nodes():
            if self.pool.refs[node.page] == 1 and node.page not in ex:
                out[node.page[0]] += 1
        return out

    def acquire(self, hashes: Sequence[int]) -> List[Tuple[int, int]]:
        """Match the longest cached prefix and take one reference per hit
        page for the admitting request. Returns the hit pages in block
        order; the caller owns the references (released via
        ``PagePool.decref`` when the request finishes or rolls back)."""
        nodes = self._walk(hashes)
        self._clock += 1
        for node in nodes:
            self.pool.incref(*node.page)
            node.stamp = self._clock
        self.hit_tokens += len(nodes) * self.page_size
        self.lookup_tokens += len(hashes) * self.page_size
        return [node.page for node in nodes]

    # ---- insert ---------------------------------------------------------
    def insert(self, hashes: Sequence[int],
               pages: Sequence[Tuple[int, int]]) -> int:
        """Retain a prefilled request's full prompt blocks.

        ``pages[b]`` must hold the valid KV of the block hashed by
        ``hashes[b]`` (the scheduler guarantees this: hit blocks come back
        in the same pages the trie already names, fresh blocks were just
        written by the prefill). Existing nodes are only LRU-touched; new
        nodes take one cache-hold reference on their page. Returns the
        number of newly retained pages.
        """
        assert len(hashes) == len(pages)
        self._clock += 1
        level = self.children
        parent: Optional[_Node] = None
        added = 0
        for h, page in zip(hashes, pages):
            node = level.get(h)
            if node is None:
                node = _Node(key=h, page=tuple(page), parent=parent)
                level[h] = node
                self.pool.incref(*page)          # the cache's own hold
                added += 1
            node.stamp = self._clock
            parent = node
            level = node.children
        self.inserted_pages += added
        return added

    # ---- eviction -------------------------------------------------------
    def _leaves(self) -> List[_Node]:
        out: List[_Node] = []
        stack = list(self.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                out.append(node)
        return out

    def _drop(self, node: _Node) -> None:
        level = node.parent.children if node.parent else self.children
        del level[node.key]
        self.pool.decref(*node.page)
        self.evicted_pages += 1

    def _chain_tokens(self, node: _Node) -> int:
        depth = 0
        cur: Optional[_Node] = node
        while cur is not None:
            depth += 1
            cur = cur.parent
        return depth * self.page_size

    def evict(self, shard: int, need: int) -> int:
        """Free up to ``need`` pages on ``shard`` by dropping leaf nodes
        nobody else references (refcount 1 == the cache's hold — a block
        shared with a live request is skipped: dropping it would not free
        a page, only forfeit future hits). Victims are the *cheapest to
        recompute* first (``cost_fn`` over tokens-in-chain, LRU stamp as
        tie-break). Blocks are round-robin over shards, so the page wanted
        on ``shard`` may sit mid-chain under leaves on *other* shards:
        when the target shard has no evictable leaf, the cheapest
        evictable leaf anywhere is dropped to unwind its chain toward one.
        With a connector attached the victim's page spills to the host
        tier before the device page is released. Returns pages freed on
        ``shard``."""
        freed = 0
        while freed < need:
            victims = [n for n in self._leaves()
                       if self.pool.refs[n.page] == 1]
            if not victims:
                break
            on_shard = [n for n in victims if n.page[0] == shard]
            victim = min(on_shard or victims,
                         key=lambda n: (self.cost_fn(self._chain_tokens(n)),
                                        n.stamp))
            if self.connector is not None:
                self.connector.spill(
                    key=victim.key, page=victim.page,
                    chain_tokens=self._chain_tokens(victim))
            self._drop(victim)
            if victim.page[0] == shard:
                freed += 1
        return freed

    def drop_all(self) -> None:
        """Release every cache hold at once, leaves first; a page a live
        request shares stays until it finishes. Not counted as eviction
        (``evicted_pages`` counts pool pressure)."""
        while True:
            leaves = self._leaves()
            if not leaves:
                break
            for node in leaves:
                self._drop(node)
                self.evicted_pages -= 1

    # ---- metrics --------------------------------------------------------
    @property
    def hit_rate(self) -> float:
        return self.hit_tokens / self.lookup_tokens if self.lookup_tokens \
            else 0.0

    def stats(self) -> Dict[str, float]:
        return {
            "hit_tokens": self.hit_tokens,
            "lookup_tokens": self.lookup_tokens,
            "hit_rate": self.hit_rate,
            "evicted_pages": self.evicted_pages,
            "inserted_pages": self.inserted_pages,
            "resident_pages": sum(1 for _ in self._iter_nodes()),
        }

    def _iter_nodes(self):
        stack = list(self.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node
