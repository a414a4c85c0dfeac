"""repro_torch.gateway — the multi-replica serving gateway over
``repro_torch.engine`` (the port of ``repro.gateway``).

Public surface:
  Gateway / build_gateway — N engine replicas on the one card, sharing one
                            model; prefix-aware and load-aware routing
                            with session affinity; per-request streams;
                            prefill/decode roles with the KV handoff
  Router                  — the routing policy (probe the replicas'
                            tries, break ties by outstanding tokens)
  PrefixCache             — block-hash trie over full prompt pages with
                            ref-counted, copy-on-write page reuse in the
                            SP-sharded paged pool; cost-aware eviction
  block_hashes            — the chain hash over token pages
"""

from repro_torch.gateway.gateway import (Gateway, build_gateway,
                                         replica_meshes, submeshes)
from repro_torch.gateway.prefix_cache import PrefixCache, block_hashes
from repro_torch.gateway.router import Router

__all__ = [
    "Gateway", "build_gateway", "replica_meshes", "submeshes",
    "PrefixCache", "block_hashes", "Router",
]
