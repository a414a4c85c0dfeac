"""Block-paged KV cache with an SP-sharded page pool (the port's
counterpart of ``repro.engine.paged_cache``).

Layout
------
Each attention layer owns a pool of fixed-size pages; the port keeps every
layer's pool in one tensor per rank

    k, v : (num_layers, pages_per_shard, page_size, Hkv, hd)

so ``pools["k"][i]`` is layer i's contiguous pool slice. A sequence's
logical block ``b`` (token positions ``[b*page_size, (b+1)*page_size)``)
lives on SP rank ``b % P_sp`` as that rank's ``b // P_sp``-th block. The
page table ``(max_slots, P_sp, W)`` int32 holds local page ids, -1 for
unallocated. Validity is encoded through positions, as everywhere else.

The JAX package's helpers are pure functions; here ``write_token`` and
``insert_prompt`` **update the pools in place**. The per-token write targets
are computed once per decode step on the host, where the scheduler keeps
the table and the lengths (``PagedTables.write_targets``), so the per-layer
writes are plain index_put calls and never wait on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import spec, transformer


class PagePool:
    """Host-side, ref-counted page free lists (one per SP shard).

    Every physical page carries a reference count: 1 for each live sequence
    whose page table points at it (plus 1 for a prefix cache, once that is
    ported). Pages return to the free list only when the count reaches zero,
    and an over-release is a loud error instead of silent cache corruption.
    """

    def __init__(self, sp: int, pages_per_shard: int):
        self.sp = sp
        self.pages_per_shard = pages_per_shard
        self.free: List[List[int]] = [
            list(range(pages_per_shard - 1, -1, -1)) for _ in range(sp)]
        self.refs = np.zeros((sp, pages_per_shard), np.int32)

    def available(self, shard: int) -> int:
        return len(self.free[shard])

    def alloc(self, shard: int) -> int:
        """Pop a free page on ``shard`` with refcount 1."""
        if not self.free[shard]:
            raise RuntimeError(
                f"page pool exhausted on shard {shard} "
                f"({self.pages_per_shard} pages)")
        page = self.free[shard].pop()
        assert self.refs[shard, page] == 0, "free-list page had live refs"
        self.refs[shard, page] = 1
        return page

    def decref(self, shard: int, page: int) -> bool:
        """Drop one reference; returns True when the page was freed."""
        if self.refs[shard, page] <= 0:
            raise ValueError(
                f"double free of page ({shard}, {page}): refcount already 0")
        self.refs[shard, page] -= 1
        if self.refs[shard, page] == 0:
            self.free[shard].append(page)
            return True
        return False

    def pages_in_use(self) -> int:
        return self.sp * self.pages_per_shard - sum(
            len(f) for f in self.free)

    def pages_total(self) -> int:
        return self.sp * self.pages_per_shard


@dataclasses.dataclass
class PagedTables:
    """One decode step's page-table view.

    table: (B, P_sp, W) int32 host copy of the scheduler's table (width
      bucketed); cache_len: (B,) int32 host copy, the new token's position;
      active: (B,) bool host copy, inactive slots write nothing.
    """

    table: np.ndarray
    cache_len: np.ndarray
    active: np.ndarray
    page_size: int
    device: torch.device
    _memo: Dict[Tuple[str, int], object] = dataclasses.field(
        default_factory=dict)

    def local_table(self, rank: int) -> torch.Tensor:
        """This rank's (B, W) slice of the table, on the device."""
        key = ("table", rank)
        if key not in self._memo:
            self._memo[key] = torch.from_numpy(np.ascontiguousarray(
                self.table[:, rank])).to(self.device)
        return self._memo[key]

    def write_targets(self, rank: int, sp: int):
        """(rows, pages, offsets) of the new tokens this rank stores, as
        device int64 tensors: the JAX ``write_token``'s arithmetic on the
        host copies."""
        key = ("write", rank)
        if key not in self._memo:
            ps = self.page_size
            tbl = self.table[:, rank]                            # (B, W)
            B, W = tbl.shape
            cl = self.cache_len.astype(np.int64)
            g = cl // ps                                         # global block
            j = g // sp                                          # local block
            page = tbl[np.arange(B), np.clip(j, 0, W - 1)]
            ok = (g % sp == rank) & (j < W) & (page >= 0) & self.active
            rows = np.nonzero(ok)[0]
            self._memo[key] = tuple(
                torch.from_numpy(a.astype(np.int64)).to(self.device)
                for a in (rows, page[rows], cl[rows] % ps))
        return self._memo[key]


def supported(cfg: ModelConfig) -> Tuple[bool, str]:
    """The engine serves decoder-only stacks whose mixers are all attention
    (paged KV is meaningless for recurrent per-slot states)."""
    if cfg.encdec:
        return False, "encoder-decoder archs use the contiguous serve path"
    if cfg.frontend_stub is not None:
        return False, "frontend (VLM/audio) archs use the contiguous serve path"
    for mixer, _ in transformer.layer_pattern(cfg):
        if mixer != "attn":
            return False, (f"mixer {mixer!r} keeps per-slot recurrent state; "
                           "paged engine v1 covers attention mixers only")
    return True, ""


def init_pools(cfg: ModelConfig, pages_loc: int, page_size: int,
               device) -> Dict[str, torch.Tensor]:
    """This rank's zeroed pools {'k','v'}: (L, pages_loc, ps, Hkv, hd)."""
    shape = (cfg.num_layers, pages_loc, page_size, cfg.num_kv_heads,
             cfg.head_dim_)
    dtype = spec.DTYPES[cfg.param_dtype]
    return {n: torch.zeros(shape, dtype=dtype, device=device)
            for n in ("k", "v")}


def write_token(rt, cache: Dict[str, torch.Tensor], k_new, v_new,
                paged: PagedTables) -> None:
    """Append one token per active slot into its owning rank's page,
    **in place**.

    cache: {'k','v'} one layer's pool slices (pages_loc, page_size, Hkv,
      hd); k_new / v_new: (B, 1, Hkv, hd), post-RoPE K and V of the new
      token.
    """
    rows, page, off = paged.write_targets(rt.sp_rank(), rt.sp_size())
    cache["k"][page, off] = k_new[rows, 0].to(cache["k"].dtype)
    cache["v"][page, off] = v_new[rows, 0].to(cache["v"].dtype)


def insert_prompt(rt, pools: Dict[str, torch.Tensor], k_stack, v_stack,
                  table_row: np.ndarray, prompt_len: int,
                  page_size: int) -> None:
    """Scatter a prefilled sequence's K/V into this rank's pool pages,
    **in place**.

    pools: {'k','v'} this rank's pools (L, pages_loc, ps, Hkv, hd).
    k_stack / v_stack: (L, 1, S_loc, Hkv, hd), the prefill cache of one
      sequence, SP-sharded contiguously (post-RoPE).
    table_row: (P_sp, W) host int32, the slot's page-table row.
    prompt_len: real prompt length; blocks past it are never written. A
      partial last block is zero-padded; the padding is written but
      unreadable: its positions exceed every cache_len until decode
      overwrites them.

    Pages are owned round-robin, so one all-gather over the SP axes
    re-materialises the prompt before each rank scatters its own blocks.
    """
    rank, sp, ps = rt.sp_rank(), rt.sp_size(), page_size
    kg = rt.all_gather_model(k_stack, axis=2)[:, 0]      # (L, S, Hkv, hd)
    vg = rt.all_gather_model(v_stack, axis=2)[:, 0]
    n_l, S = kg.shape[0], kg.shape[1]
    G = -(-S // ps)
    if G * ps != S:
        kg = torch.nn.functional.pad(kg, (0, 0, 0, 0, 0, G * ps - S))
        vg = torch.nn.functional.pad(vg, (0, 0, 0, 0, 0, G * ps - S))
    kb = kg.reshape(n_l, G, ps, *kg.shape[2:])
    vb = vg.reshape(n_l, G, ps, *vg.shape[2:])
    tbl = table_row[rank]                                # (W,)
    W = tbl.shape[0]
    gidx = np.arange(G)
    j = gidx // sp
    page = tbl[np.clip(j, 0, W - 1)]
    mine = (gidx % sp == rank) & (gidx * ps < prompt_len) & (j < W) \
        & (page >= 0)
    sel = torch.from_numpy(np.nonzero(mine)[0]).to(kb.device)
    dst = torch.from_numpy(page[mine].astype(np.int64)).to(kb.device)
    pools["k"][:, dst] = kb[:, sel].to(pools["k"].dtype)
    pools["v"][:, dst] = vb[:, sel].to(pools["v"].dtype)
