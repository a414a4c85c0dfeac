"""The contiguous serving cache of the static-batch path (the port's
counterpart of ``repro.serve.kv_cache``, attention layers only).

Layout, per rank: every layer's K and V in one tensor each,

    k, v : (num_layers, B, S_local, Hkv, hd)

the rank's contiguous slice of a capacity-sized cache (``capacity`` a
multiple of the SP degree). Slot ``s`` of rank ``r`` holds position
``r * S_local + s``; a decode step treats positions ``<= cache_len`` as
filled and writes the new token at ``cache_len`` on its owning rank.
Recurrent-state layers (mamba, mLSTM, sLSTM) are not ported, so only
all-attention stacks are served, as ``engine.paged_cache.supported``
decides. ``write_token`` updates the cache **in place**.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.engine import paged_cache
from repro_torch.models import spec


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device) -> Dict[str, torch.Tensor]:
    """A zeroed cache {'k','v'}: (L, batch, capacity, Hkv, hd)."""
    ok, why = paged_cache.supported(cfg)
    if not ok:
        raise NotImplementedError(f"repro_torch.serve: {cfg.name}: {why}")
    shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads,
             cfg.head_dim_)
    dtype = spec.DTYPES[cfg.param_dtype]
    return {n: torch.zeros(shape, dtype=dtype, device=device)
            for n in ("k", "v")}


def write_token(rt, cache: Dict[str, torch.Tensor], k_new, v_new,
                cache_len: torch.Tensor) -> None:
    """Write each row's new token at position ``cache_len`` into its owning
    rank's slot, **in place**, without a host sync.

    cache: {'k','v'} one layer's slices (B, S_local, Hkv, hd); k_new /
    v_new: (B, 1, Hkv, hd); cache_len: (B,) int device tensor.
    """
    s_loc = cache["k"].shape[1]
    slot = cache_len.long() - rt.sp_rank() * s_loc
    own = ((slot >= 0) & (slot < s_loc))[:, None, None]
    slot = slot.clamp(0, s_loc - 1)
    rows = torch.arange(slot.shape[0], device=slot.device)
    for name, new in (("k", k_new), ("v", v_new)):
        t = cache[name]
        t[rows, slot] = torch.where(own, new[:, 0].to(t.dtype), t[rows, slot])
