"""Request routing across engine replicas (the port's copy of
``repro.gateway.router``, which imports no JAX).

Three signals, in priority order:

* **session affinity** — a request carrying a ``session`` key goes to the
  replica that served that session before (its earlier turns' KV pages are
  in that replica's pool, so the prefix trie can hit them); the map is
  sticky until the caller resets the gateway.
* **prefix awareness** — otherwise each replica's trie is probed read-only
  (``PrefixCache.match_len``) with the request's block hashes, and the
  replica with the most cached prefix tokens wins: prefill work already
  paid anywhere should never be paid again somewhere else.
* **load** — ties (including the cold everyone-misses case) break to the
  replica with the fewest outstanding tokens (queued + remaining decode
  budget), then to the lowest replica index (deterministic routing — the
  serving benchmark replays workloads across cache-on/off phases and needs
  identical placement to compare tokens bit-for-bit).

Disaggregated gateways restrict new requests to the ``eligible`` replica
indices (the prefill/unified ones) — decode-role replicas only ever see
KV handed to them via ``Engine.add_prefilled``, never a raw prompt.

The ``engines`` need not be in-process ``Engine`` objects: anything with
an ``outstanding_tokens()`` method (e.g. ``repro_torch.frontend``'s replica
clients, whose scheduler lives in another process) routes by that load
signal instead of a scheduler walk. **Liveness**: ``mark_dead(i)``
removes a replica from routing (a dead worker process must stop
receiving traffic instantly); its sticky sessions re-route on next use.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set


class Router:
    def __init__(self, engines: Sequence, *, prefix_aware: bool = True,
                 eligible: Optional[Sequence[int]] = None):
        self.engines = list(engines)
        self.prefix_aware = prefix_aware
        self.eligible = list(eligible) if eligible is not None \
            else list(range(len(self.engines)))
        self.affinity: Dict[str, int] = {}
        self.affinity_hits = 0
        self.routed: List[int] = [0] * len(self.engines)
        self.dead: Set[int] = set()

    # ---- liveness -------------------------------------------------------
    def mark_dead(self, i: int) -> None:
        """Stop routing to replica ``i`` (worker process died or is being
        drained). Sticky sessions pointing at it re-route on next use."""
        self.dead.add(i)
        self.affinity = {s: j for s, j in self.affinity.items() if j != i}

    def live_eligible(self) -> List[int]:
        return [i for i in self.eligible if i not in self.dead]

    def load(self, i: int) -> int:
        """Outstanding tokens on replica ``i`` (queued + admitted)."""
        eng = self.engines[i]
        fn = getattr(eng, "outstanding_tokens", None)
        if fn is not None:
            return fn()
        sched = eng.scheduler
        t = sum(r.prompt_len + r.max_new_tokens for r in sched.queue)
        t += sum(s.req.prompt_len + s.req.max_new_tokens - len(s.out)
                 for s in sched.active())
        return t

    def cached_tokens(self, i: int, req) -> int:
        cache = getattr(self.engines[i], "prefix_cache", None)
        if not self.prefix_aware or cache is None:
            return 0
        return cache.match_len(cache.hashes(req.tokens)) * cache.page_size

    def route(self, req, session: Optional[str] = None) -> int:
        live = self.live_eligible()
        if not live:
            raise RuntimeError("router: no live eligible replica")
        if session is not None and session in self.affinity:
            i = self.affinity[session]
            self.affinity_hits += 1
        else:
            i = min(live,
                    key=lambda j: (-self.cached_tokens(j, req),
                                   self.load(j), j))
            if session is not None:
                self.affinity[session] = i
        self.routed[i] += 1
        return i
