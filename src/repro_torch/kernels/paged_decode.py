"""Paged decode attention, B4 (``repro.kernels.paged_decode._kernel``): one
query token per row against this SP shard's page-table-indexed pool.

``paged_decode_attention`` launches ``csrc/paged_decode.cu`` on CUDA tensors
(bf16: the tensor-core forward of ``csrc/flash_fwd.cuh`` over the paged
source, its keys split over ``decode_splits`` CTAs per (row, kv head) when
the G = Hq/Hkv query heads of a group fit one 16-row slab, unsplit above;
f32: the CUDA-core kernel) at every head size of ``HEAD_DIMS``, any page
size and any G, and runs the plain PyTorch version
(``paged_decode_attention_plain``: gather the table's pages densely, encode
validity in positions, and reuse the ``ref.block_attention`` oracle) on CPU
tensors. There is no fallback: a CUDA tensor the kernel does not take
raises. ``LAUNCHES`` counts the launches.

q (B,1,Hq,D); pool_k/pool_v (pages_loc,page_size,Hkv,D); table (B,W) int32
(-1 = unallocated); cache_len (B,) int32, the new token's position; rank is
this shard's SP rank. Page ``w`` covers positions
``[(w*sp + rank)*page_size, ...)``. Returns partial (o (B,1,Hq,D),
lse (B,Hq,1)) in f32.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import meta, ref
from repro_torch.kernels.flash_attention import (
    DTYPES, HEAD_DIMS, _check, check_head_dim)

LAUNCHES: Dict[str, int] = {"B4": 0}
# the ranks of a ThreadMesh engine launch B4 from their own threads
_LAUNCHES_LOCK = threading.Lock()
TILE_KEYS = 64          # the bf16 kernel's key tile (key_tiles)
# split-KV scratch per device, sized by the C entry
# (repro_paged_decode_scratch), allocated once and grown only for a larger
# call: the CTAs' partial (m, l, acc) and ticket counters, which the kernel
# leaves at zero. Calls on one device share it, so they run on one stream
# at a time (the port's current stream)
_WORKSPACE: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def reset_launches() -> None:
    LAUNCHES["B4"] = 0


def paged_decode_attention_plain(q, pool_k, pool_v, table, cache_len, rank,
                                 *, sp: int, page_size: int,
                                 window: Optional[int] = None,
                                 scale: Optional[float] = None):
    """Dense gather of the table's pages + ``ref.block_attention``; invalid
    slots get position ``cache_len + 1`` so the causal mask drops them."""
    pages_loc = pool_k.shape[0]
    B, W = table.shape
    dev = q.device
    safe = table.long().clamp(0, pages_loc - 1)
    k_r = pool_k[safe].reshape(B, W * page_size, *pool_k.shape[2:])
    v_r = pool_v[safe].reshape(B, W * page_size, *pool_v.shape[2:])
    pos = ((torch.arange(W, dtype=torch.int32, device=dev) * sp + int(rank))
           * page_size)[:, None] \
        + torch.arange(page_size, dtype=torch.int32, device=dev)[None]
    pos = pos.reshape(W * page_size)
    cl = cache_len.to(torch.int32)
    valid = torch.repeat_interleave(table >= 0, page_size, dim=1)
    valid = valid & (pos[None] <= cl[:, None])
    pos_k = torch.where(valid, pos[None], (cl + 1)[:, None])
    return ref.block_attention(q, k_r, v_r, cl[:, None], pos_k, causal=True,
                               window=window, scale=scale)


def key_tiles(W: int, page_size: int) -> int:
    """64-key tiles of the bf16 kernel over a W-entry table: pages of up
    to 64 keys go ``64 // page_size`` whole pages a tile, larger ones
    ``ceil(page_size / 64)`` tiles a page."""
    if page_size <= TILE_KEYS:
        return -(-W // (TILE_KEYS // page_size))
    return W * -(-page_size // TILE_KEYS)


def decode_splits(B: int, Hkv: int, D: int, W: int, page_size: int,
                  sms: int) -> int:
    """CTAs per (row, kv head, D slice) of the bf16 kernel where a
    group's G query heads fit one 16-row slab (the launch reads it only
    there; ``repro_paged_decode_scratch`` sizes its scratch): as many as
    fill the card's ``sms`` SMs in one wave (its shared memory holds one
    CTA per SM; on an H100 at batch 4, 5 splits, 160 CTAs on 132 SMs, took
    0.024 device-ms against 4 splits' 0.019: ``scripts/compare_paged.py``),
    but no more than give each of a CTA's walking warps (4, or 2 at D =
    128 and 256) a tile of the table's. Above D = 128 each (row, kv head)
    has a CTA per 128 output columns."""
    walkers = 2 if D > 80 else 4
    ctas = B * Hkv * (D // 128 if D > 128 else 1)
    return max(1, min(sms // ctas, -(-key_tiles(W, page_size) // walkers)))


def _workspace(dev, n_ws: int, n_tickets: int):
    ws, tickets = _WORKSPACE.get(dev, (None, None))
    if ws is None or ws.numel() < n_ws:
        ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=dev)
    _WORKSPACE[dev] = (ws, tickets)
    return ws, tickets


def paged_decode_attention(q, pool_k, pool_v, table, cache_len, rank: int,
                           *, sp: int, page_size: int,
                           window: Optional[int] = None,
                           scale: Optional[float] = None):
    """Per-shard paged decode attention -> partial (o, lse)."""
    B, M, Hq, D = q.shape
    if M != 1:
        raise ValueError(f"paged decode takes one query per row, got M={M}")
    pages_loc, ps, Hkv, _ = pool_k.shape
    if ps != page_size:
        raise ValueError(f"pool page size {ps} != page_size {page_size}")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, pool_k, pool_v, table, cache_len, rank, sp=sp,
            page_size=page_size, window=window, scale=scale)
    from repro_torch.kernels import _build

    check_head_dim(D, HEAD_DIMS)
    if Hkv < 1 or Hq % Hkv or page_size < 1:
        raise ValueError(f"kernel takes Hq % Hkv == 0 and page_size >= 1, "
                         f"got Hq={Hq} Hkv={Hkv} page_size={page_size}")
    W = table.shape[1]
    dev = q.device
    _check("q", q, (B, 1, Hq, D), DTYPES, dev)
    _check("pool_k", pool_k, (pages_loc, ps, Hkv, D), (q.dtype,), dev)
    _check("pool_v", pool_v, (pages_loc, ps, Hkv, D), (q.dtype,), dev)
    _check("table", table, (B, W), (torch.int32,), dev)
    _check("cache_len", cache_len, (B,), (torch.int32,), dev)
    o = torch.empty((B, 1, Hq, D), dtype=torch.float32, device=dev)
    lse = torch.empty((B, Hq, 1), dtype=torch.float32, device=dev)
    if q.is_meta:
        kv = 2 * B * W * page_size * Hkv * D * pool_k.element_size()
        return meta.charge(
            "B4", meta.attention_flops(q, W * page_size),
            kv + meta.io_bytes(q, table, cache_len, o, lse), (o, lse))
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    lib = _build.library()
    splits, ws, tickets = 1, None, None
    if q.dtype == torch.bfloat16:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = decode_splits(B, Hkv, D, W, page_size, sms)
    sizes = (ctypes.c_longlong * 2)()
    _build.check(lib.repro_paged_decode_scratch(
        B, Hq, Hkv, D, splits, DTYPES[q.dtype], sizes), "paged_decode")
    if sizes[0]:
        ws, tickets = _workspace(dev, sizes[0], sizes[1])
    err = lib.repro_paged_decode(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), table.data_ptr(),
        cache_len.data_ptr(), o.data_ptr(), lse.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(), B, Hq, Hkv, D,
        pages_loc, page_size, W, int(sp), int(rank),
        int(window is not None), int(window or 0), splits, float(scale),
        DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "paged_decode")
    with _LAUNCHES_LOCK:
        LAUNCHES["B4"] += 1
    return o, lse
