"""Paged suffix-prefill attention, B6 (``repro.kernels.paged_prefill``): a
block of suffix queries against this SP shard's page-table-indexed pool,
the cached-prefix partial of a prefix-cached or chunked prefill.

``paged_prefill_attention`` launches ``csrc/paged_prefill.cu`` on CUDA
tensors (bf16: the tensor-core forward of ``csrc/flash_fwd.cuh`` over the
paged source, 64 packed (query, head) rows of a kv group per CTA; f32: the
CUDA-core kernel) at every head size of ``HEAD_DIMS`` and any page size,
and runs the plain PyTorch version
(``paged_prefill_attention_plain``: gather the table's pages densely,
encode validity in positions, and reuse the ``ref.block_attention``
oracle, as the JAX ``dispatch.paged_prefill(impl='ref')`` does) on CPU
tensors. There is no fallback: a CUDA tensor the kernel does not take
raises. ``LAUNCHES`` counts the launches.

q (B,Sq,Hq,D), row b's query i at global position ``cached_len[b] + i``;
pool_k/pool_v (pages_loc,page_size,Hkv,D); table (B,W) int32 (-1 =
unallocated); cached_len (B,) int32; rank is this shard's SP rank. Page
``w`` covers positions ``[(w*sp + rank)*page_size, ...)``; a key is
visible iff its position is ``< cached_len`` (and inside the window).
Returns partial (o (B,Sq,Hq,D), lse (B,Hq,Sq)) in f32; a row with no
visible key gives o = 0 and lse = -1e30 exactly.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from repro_torch.kernels import meta, ref
from repro_torch.kernels.flash_attention import (
    DTYPES, HEAD_DIMS, _check, check_head_dim)

LAUNCHES: Dict[str, int] = {"B6": 0}
# the ranks of a ThreadMesh engine launch B6 from their own threads
_LAUNCHES_LOCK = threading.Lock()


def reset_launches() -> None:
    LAUNCHES["B6"] = 0


def paged_prefill_attention_plain(q, pool_k, pool_v, table, cached_len,
                                  rank, *, sp: int, page_size: int,
                                  window: Optional[int] = None,
                                  scale: Optional[float] = None):
    """Dense gather of the table's pages + ``ref.block_attention``; slots
    that are unallocated or at/past ``cached_len`` get position
    ``cached_len + Sq``, past every query, so the causal mask drops them."""
    pages_loc = pool_k.shape[0]
    B, W = table.shape
    Sq = q.shape[1]
    dev = q.device
    safe = table.long().clamp(0, pages_loc - 1)
    k_r = pool_k[safe].reshape(B, W * page_size, *pool_k.shape[2:])
    v_r = pool_v[safe].reshape(B, W * page_size, *pool_v.shape[2:])
    pos = ((torch.arange(W, dtype=torch.int32, device=dev) * sp + int(rank))
           * page_size)[:, None] \
        + torch.arange(page_size, dtype=torch.int32, device=dev)[None]
    pos = pos.reshape(W * page_size)
    cl = cached_len.to(torch.int32)
    valid = torch.repeat_interleave(table >= 0, page_size, dim=1)
    valid = valid & (pos[None] < cl[:, None])
    pos_k = torch.where(valid, pos[None], (cl + Sq)[:, None])
    pos_q = cl[:, None] + torch.arange(Sq, dtype=torch.int32, device=dev)[None]
    return ref.block_attention(q, k_r.to(q.dtype), v_r.to(q.dtype), pos_q,
                               pos_k, causal=True, window=window, scale=scale)


def paged_prefill_attention(q, pool_k, pool_v, table, cached_len, rank: int,
                            *, sp: int, page_size: int,
                            window: Optional[int] = None,
                            scale: Optional[float] = None):
    """Per-shard suffix-vs-prefix paged attention -> partial (o, lse)."""
    B, Sq, Hq, D = q.shape
    pages_loc, ps, Hkv, _ = pool_k.shape
    if ps != page_size:
        raise ValueError(f"pool page size {ps} != page_size {page_size}")
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, pool_k, pool_v, table, cached_len, rank, sp=sp,
            page_size=page_size, window=window, scale=scale)
    from repro_torch.kernels import _build

    check_head_dim(D, HEAD_DIMS)
    if Hkv < 1 or Hq % Hkv or page_size < 1:
        raise ValueError(f"kernel takes Hq % Hkv == 0 and page_size >= 1, "
                         f"got Hq={Hq} Hkv={Hkv} page_size={page_size}")
    W = table.shape[1]
    dev = q.device
    _check("q", q, (B, Sq, Hq, D), DTYPES, dev)
    _check("pool_k", pool_k, (pages_loc, ps, Hkv, D), (q.dtype,), dev)
    _check("pool_v", pool_v, (pages_loc, ps, Hkv, D), (q.dtype,), dev)
    _check("table", table, (B, W), (torch.int32,), dev)
    _check("cached_len", cached_len, (B,), (torch.int32,), dev)
    o = torch.empty((B, Sq, Hq, D), dtype=torch.float32, device=dev)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    if q.is_meta:
        kv = 2 * B * W * page_size * Hkv * D * pool_k.element_size()
        return meta.charge(
            "B6", meta.attention_flops(q, W * page_size),
            kv + meta.io_bytes(q, table, cached_len, o, lse), (o, lse))
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    lib = _build.library()
    err = lib.repro_paged_prefill(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), table.data_ptr(),
        cached_len.data_ptr(), o.data_ptr(), lse.data_ptr(), B, Sq, Hq, Hkv,
        D, pages_loc, page_size, W, int(sp), int(rank),
        int(window is not None), int(window or 0), float(scale),
        DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "paged_prefill")
    with _LAUNCHES_LOCK:
        LAUNCHES["B6"] += 1
    return o, lse
