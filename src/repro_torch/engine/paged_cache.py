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

The JAX package's helpers are pure functions; here ``write_token``,
``insert_prompt`` and ``write_blocks`` **update the pools in place**. The
write targets are computed on the host, where the scheduler keeps the table
and the lengths (``PagedTables.write_targets`` once per decode step,
``block_targets`` once per prefill), so the per-layer writes are plain
index calls and never wait on the device. ``read_pages`` / ``write_pages``
move whole pages by global page id between the pools and the host KV tier
(``engine.kv_connector``), on the thread that drives the engine: it reads
and writes every ``ThreadMesh`` rank's pool in place. A rank process holds
its own pool alone, so there ``read_pages_rank`` / ``write_pages_rank``
(the JAX functions' form) move them: a page lives whole in one SP shard's
pool, the psum over the SP axes brings every page to every rank, and each
rank writes the pages it owns out of the batch every rank holds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import spec, transformer


class PagePool:
    """Host-side, ref-counted page free lists (one per SP shard).

    Every physical page carries a reference count: 1 for each live sequence
    whose page table points at it, plus 1 when the prefix cache
    (``gateway.prefix_cache``) retains it. Pages return to the free list only
    when the count reaches zero, so a shared prefix page outlives any single
    request, and an over-release is a loud error instead of silent cache
    corruption.
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

    def incref(self, shard: int, page: int) -> None:
        if self.refs[shard, page] <= 0:
            raise ValueError(
                f"incref of free page ({shard}, {page}): stale reference")
        self.refs[shard, page] += 1

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


def block_targets(rt, table_row: np.ndarray, start: int, n_tokens: int,
                  page_size: int):
    """(blocks, pages) of the K/V blocks this rank stores when ``n_tokens``
    prompt tokens from position ``start`` (a multiple of ``page_size``) are
    written, as device int64 tensors: block g of them (positions
    ``start + g*page_size ..``) is global block ``start // page_size + g``,
    owned round-robin, stored in the table's page of that block."""
    rank, sp, ps = rt.sp_rank(), rt.sp_size(), page_size
    if start % ps:
        raise ValueError(f"start={start} is not a multiple of "
                         f"page_size={ps}")
    tbl = table_row[rank]                                # (W,)
    W = tbl.shape[0]
    gidx = np.arange(-(-n_tokens // ps))
    gglob = start // ps + gidx
    j = gglob // sp
    page = tbl[np.clip(j, 0, W - 1)]
    mine = (gglob % sp == rank) & (j < W) & (page >= 0)
    return tuple(torch.from_numpy(a.astype(np.int64)).to(rt.device)
                 for a in (np.nonzero(mine)[0], page[mine]))


def write_blocks(pools: Dict[str, torch.Tensor], k, v, targets) -> None:
    """Scatter K/V by whole blocks into this rank's pages, **in place**.

    pools: {'k','v'} (..., pages_loc, page_size, Hkv, hd); k / v:
    (..., S, Hkv, hd) post-RoPE, with the pools' leading dims; targets:
    ``block_targets``. A partial last block is zero-padded: the padding is
    unreadable (its positions exceed every cache_len) until decode
    overwrites it.
    """
    blocks, pages = targets
    ps = pools["k"].shape[-3]
    S = k.shape[-3]
    G = -(-S // ps)
    for name, t in (("k", k), ("v", v)):
        if G * ps != S:
            t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, G * ps - S))
        t = t.reshape(*t.shape[:-3], G, ps, *t.shape[-2:])
        dst = pools[name]
        dst.index_copy_(dst.dim() - 4, pages,
                        t.index_select(t.dim() - 4, blocks).to(dst.dtype))


def insert_prompt(rt, pools: Dict[str, torch.Tensor], k_stack, v_stack,
                  table_row: np.ndarray, prompt_len: int,
                  page_size: int) -> None:
    """Scatter a prefilled sequence's K/V into this rank's pool pages,
    **in place**.

    pools: {'k','v'} this rank's pools (L, pages_loc, ps, Hkv, hd).
    k_stack / v_stack: (L, 1, S_loc, Hkv, hd), the prefill cache of one
      sequence of ``S_loc * P_sp`` prompt tokens, SP-sharded contiguously
      (post-RoPE).
    table_row: (P_sp, W) host int32, the slot's page-table row.
    prompt_len: the real prompt length; blocks wholly past it are padding
      and are not written, while padding inside the last real block is
      written but unreadable (its positions exceed every cache_len until
      decode overwrites them).

    Pages are owned round-robin, so one all-gather over the SP axes
    re-materialises the prompt before each rank scatters its own blocks.
    """
    kg = rt.all_gather_model(k_stack, axis=2)[:, 0]      # (L, S, Hkv, hd)
    vg = rt.all_gather_model(v_stack, axis=2)[:, 0]
    write_blocks(pools, kg, vg,
                 block_targets(rt, table_row, 0, prompt_len, page_size))


# Pools of every rank holding one SP shard, data replica 0 first.
ShardPools = Sequence[Sequence[Dict[str, torch.Tensor]]]


def _owned(idx: np.ndarray, shard: int, pages_loc: int, device
           ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(positions in ``idx``, local pages) of the global ids that ``shard``
    owns, as device int64 tensors; None when it owns none. The copies do
    not wait for the stream (a blocking one would wait for every kernel
    queued before it)."""
    mine = np.nonzero((idx >= 0) & (idx // pages_loc == shard))[0]
    if not len(mine):
        return None
    return tuple(torch.from_numpy(a).to(device, non_blocking=True)
                 for a in (mine, idx[mine] - shard * pages_loc))


def read_pages(shards: ShardPools, idx) -> Dict[str, torch.Tensor]:
    """Gather whole pages by *global* page id.

    shards: per SP shard, the pools {'k','v'} (L, pages_loc, ps, Hkv, hd)
      of every rank that holds it, data replica 0 first.
    idx: (B,) global page ids (``shard * pages_loc + local_page``); -1
      (the JAX connector's bucket padding) reads as zeros.

    Returns {'k','v'} (L, B, ps, Hkv, hd) on the pools' device. Each page
    comes from data replica 0's rank of its shard. The driving thread of a
    ``ThreadMesh`` engine reads every rank's pool directly; rank processes
    use ``read_pages_rank``, the JAX function's psum over the SP axes.
    This is the device leg of the KV connector's spill and of the prefill
    -> decode handoff's export.
    """
    idx = np.asarray(idx, np.int64)
    first = shards[0][0]
    pages_loc = first["k"].shape[1]
    out = {n: t.new_zeros((t.shape[0], len(idx)) + tuple(t.shape[2:]))
           for n, t in first.items()}
    for s, replicas in enumerate(shards):
        owned = _owned(idx, s, pages_loc, first["k"].device)
        if owned is None:
            continue
        pos, local = owned
        for n, t in replicas[0].items():
            out[n].index_copy_(1, pos, t.index_select(1, local))
    return out


def write_pages(shards: ShardPools, idx, data: Dict[str, torch.Tensor]
                ) -> None:
    """Scatter whole pages by global page id, **in place** (the inverse of
    ``read_pages``).

    data: {'k','v'} (L, B, ps, Hkv, hd) on the host (pinned for an
    asynchronous copy) or the device. Each shard's rank in **every** data
    replica writes the entries whose page it owns (the replicas hold
    identical pools); -1 and out-of-range ids drop. This
    is the device leg of the connector's reload and of the handoff's
    injection.
    """
    idx = np.asarray(idx, np.int64)
    first = shards[0][0]
    pages_loc, dev = first["k"].shape[1], first["k"].device
    src = {n: t.to(dev, non_blocking=True) for n, t in data.items()}
    for s, replicas in enumerate(shards):
        owned = _owned(idx, s, pages_loc, dev)
        if owned is None:
            continue
        pos, local = owned
        for n, t in src.items():
            if len(pos) < len(idx):
                t = t.index_select(1, pos)
            vals = t.to(first[n].dtype)
            for pools in replicas:
                pools[n].index_copy_(1, local, vals)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elements as integers of their width (a view)."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def read_pages_rank(rt, pools: Dict[str, torch.Tensor], idx
                    ) -> Dict[str, torch.Tensor]:
    """``read_pages`` on one rank process (the JAX ``read_pages``): this
    rank's pools {'k','v'} (L, pages_loc, ps, Hkv, hd) contribute the pages
    its SP shard owns, zeros elsewhere, and a psum over the SP axes gives
    every rank the whole batch (L, B, ps, Hkv, hd) on the pools' device;
    -1 reads as zeros. Every rank of the mesh must call it with the same
    ``idx``; each data replica sums its own ranks', which hold the same
    pages. The pages are summed as the integers of their bits, so a page
    plus the other shards' zeros is the owner's page bit for bit (a float
    -0.0 stays -0.0). Off the ledger, as the ``ThreadMesh`` engine's
    direct reads move nothing (the engine's module doc)."""
    idx = np.asarray(idx, np.int64)
    pages_loc = pools["k"].shape[1]
    owned = _owned(idx, rt.sp_rank(), pages_loc, pools["k"].device)
    out = {}
    for n, t in pools.items():
        mine = t.new_zeros((t.shape[0], len(idx)) + tuple(t.shape[2:]))
        if owned is not None:
            pos, local = owned
            mine.index_copy_(1, pos, t.index_select(1, local))
        with rt.comm.ledger.uncounted():
            out[n] = rt.psum_model(_bits(mine)).view(t.dtype)
    return out


def write_pages_rank(rt, pools: Dict[str, torch.Tensor], idx,
                     data: Dict[str, torch.Tensor]) -> None:
    """``write_pages`` on one rank process (the JAX ``write_pages``), **in
    place**: ``data`` {'k','v'} (L, B, ps, Hkv, hd), the same batch on every
    rank (host or device), and this rank writes the entries whose page its
    SP shard owns into its pools; -1 and out-of-range ids drop. Every data
    replica's rank of a shard writes, so the replicas' pools stay equal.
    No collective."""
    idx = np.asarray(idx, np.int64)
    pages_loc, dev = pools["k"].shape[1], pools["k"].device
    owned = _owned(idx, rt.sp_rank(), pages_loc, dev)
    if owned is None:
        return
    pos, local = owned
    for n, t in data.items():
        t = t.to(dev, non_blocking=True)
        if len(pos) < len(idx):
            t = t.index_select(1, pos)
        pools[n].index_copy_(1, local, t.to(pools[n].dtype))
