"""repro_torch.gateway — the serving gateway's pieces (the port of
``repro.gateway``). Only the block-hash prefix cache is ported; the router
and the multi-replica gateway are not (ROADMAP.md §A).
"""

from repro_torch.gateway.prefix_cache import PrefixCache, block_hashes

__all__ = ["PrefixCache", "block_hashes"]
