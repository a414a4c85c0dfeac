"""Paged decode attention, B4 (``repro.kernels.paged_decode._kernel``): one
query token per row against this SP shard's page-table-indexed pool.

``paged_decode_attention`` launches ``csrc/paged_decode.cu`` on CUDA tensors
and runs the plain PyTorch version (``paged_decode_attention_plain``: gather
the table's pages densely, encode validity in positions, and reuse the
``ref.block_attention`` oracle) on CPU tensors. There is no fallback: a CUDA
tensor the kernel does not take raises. ``LAUNCHES`` counts the launches.

q (B,1,Hq,D); pool_k/pool_v (pages_loc,page_size,Hkv,D); table (B,W) int32
(-1 = unallocated); cache_len (B,) int32, the new token's position; rank is
this shard's SP rank. Page ``w`` covers positions
``[(w*sp + rank)*page_size, ...)``. Returns partial (o (B,1,Hq,D),
lse (B,Hq,1)) in f32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS, _check

LAUNCHES: Dict[str, int] = {"B4": 0}


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
    if not q.is_cuda:
        return paged_decode_attention_plain(
            q, pool_k, pool_v, table, cache_len, rank, sp=sp,
            page_size=page_size, window=window, scale=scale)
    from repro_torch.kernels import _build

    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in the kernel's {HEAD_DIMS}")
    if Hq % Hkv or Hq // Hkv > 16 or not 1 <= page_size <= 64:
        raise ValueError(f"kernel takes G = Hq/Hkv <= 16 and page_size <= "
                         f"64, got Hq={Hq} Hkv={Hkv} page_size={page_size}")
    W = table.shape[1]
    dev = q.device
    _check("q", q, (B, 1, Hq, D), DTYPES, dev)
    _check("pool_k", pool_k, (pages_loc, ps, Hkv, D), (q.dtype,), dev)
    _check("pool_v", pool_v, (pages_loc, ps, Hkv, D), (q.dtype,), dev)
    _check("table", table, (B, W), (torch.int32,), dev)
    _check("cache_len", cache_len, (B,), (torch.int32,), dev)
    o = torch.empty((B, 1, Hq, D), dtype=torch.float32, device=dev)
    lse = torch.empty((B, Hq, 1), dtype=torch.float32, device=dev)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    lib = _build.library()
    err = lib.repro_paged_decode(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), table.data_ptr(),
        cache_len.data_ptr(), o.data_ptr(), lse.data_ptr(), B, Hq, Hkv, D,
        pages_loc, page_size, W, int(sp), int(rank),
        int(window is not None), int(window or 0), float(scale),
        DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "paged_decode")
    LAUNCHES["B4"] += 1
    return o, lse
