"""The single attention-kernel dispatch layer of the port (mirrors
``repro.kernels.dispatch``).

Every attention call site in ``core/``, ``serve/`` and ``models/`` goes
through this module. One ``impl`` knob selects the backend:

  'ref'   plain PyTorch (``kernels.ref``) on any device
  'cuda'  the hand-written kernels: ``flash_attention_fwd`` (B1/B2),
          ``flash_attention_bwd`` (B3), ``paged_decode_attention`` (B4),
          ``ragged_prefill_fwd`` (B5), ``paged_prefill_attention`` (B6)
          and ``flash_attention_bwd_ragged`` (B7).
          On CUDA tensors they launch the kernel or raise; on CPU tensors
          they run their plain version; on meta tensors (the dry run's
          trace, ``launch.dryrun``) their meta rule (``kernels.meta``):
          the launch's checks, so it raises where the kernel raises, and
          the kernel's outputs, its FLOPs and bytes charged to the trace,
          nothing launched. No 'cuda' call on meta tensors reaches a
          plain version. On bf16 inputs every kernel runs
          on the tensor cores (B1, B2, B4, B5, B6: the forward tile of
          ``csrc/flash_fwd.cuh``, B4 and B6 through its paged K/V source;
          B3, B7: ``csrc/flash_bwd.cuh``); f32 inputs run CUDA-core
          kernels.

Entry points:
    block_fwd / block_fwd_merge  one (Q block x K/V block) pair of a ring
                                 step; the merge form folds the block into
                                 the running (o_acc, lse_acc), fused into
                                 the B2 epilogue on 'cuda'. Batched (B, S)
                                 positions run B5 on 'cuda'
    block_bwd                    the flash backward of one block pair (B3);
                                 batched (B, S) positions run B7 on 'cuda'
    prefill                      full masked attention (o only, q's dtype)
    decode                       per-shard partial (o, lse) of M queries vs
                                 a dense cache slice
    paged_decode                 per-shard partial (o, lse) straight off a
                                 page-table-indexed pool
    paged_prefill                suffix queries vs the cached-prefix pages
                                 (the prefix-cached / chunked prefill
                                 partial), straight off the pool on 'cuda'
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.combine import combine_pair
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_decode as _paged
from repro_torch.kernels import paged_prefill as _paged_pre
from repro_torch.kernels import ragged_bwd as _ragged_bwd
from repro_torch.kernels import ragged_prefill as _ragged
from repro_torch.kernels import ref as _ref

IMPLS = ("ref", "cuda")


def resolve_impl(impl: Optional[str] = None) -> str:
    """'ref' | 'cuda'; None/'auto' picks 'cuda' (which runs the plain
    versions on CPU tensors)."""
    if impl in (None, "", "auto"):
        return "cuda"
    if impl not in IMPLS:
        raise ValueError(f"attention impl must be one of {IMPLS} (or None "
                         f"for the default), got {impl!r}")
    return impl


def _batched(*pos) -> bool:
    return any(p.dim() > 1 for p in pos)


def block_fwd(q, k, v, pos_q, pos_k, *, causal=True, window=None, scale=None,
              prefix_len=None, impl="ref") -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked (Q block x K/V block) attention -> (o, lse) partials."""
    if impl == "cuda":
        if not _batched(pos_q, pos_k):
            return _flash.flash_attention_fwd(
                q, k, v, pos_q, pos_k, causal=causal, window=window,
                scale=scale, prefix_len=prefix_len)
        return _ragged.ragged_prefill_fwd(
            q, k, v, pos_q, pos_k, causal=causal, window=window, scale=scale,
            prefix_len=prefix_len)
    return _ref.block_attention(q, k, v, pos_q, pos_k, causal=causal,
                                window=window, scale=scale,
                                prefix_len=prefix_len)


def block_fwd_merge(q, k, v, o_acc, lse_acc, pos_q, pos_k, *, causal=True,
                    window=None, scale=None, prefix_len=None, impl="ref"):
    """One ring step: ``combine_pair(o_acc, lse_acc, *block_fwd(...))``,
    the combine fused into the B2 kernel epilogue on 'cuda' (batched
    positions: B5, then the explicit combine)."""
    if impl == "cuda" and not _batched(pos_q, pos_k):
        return _flash.flash_attention_fwd(
            q, k, v, pos_q, pos_k, o_acc=o_acc, lse_acc=lse_acc,
            causal=causal, window=window, scale=scale, prefix_len=prefix_len)
    o_s, lse_s = block_fwd(q, k, v, pos_q, pos_k, causal=causal,
                           window=window, scale=scale, prefix_len=prefix_len,
                           impl=impl)
    return combine_pair(o_acc, lse_acc, o_s, lse_s)


def block_bwd(q, k, v, do, lse, delta, pos_q, pos_k, *, causal=True,
              window=None, scale=None, prefix_len=None, impl="ref"):
    """Flash backward for one block pair -> (dq, dk, dv) in float32, from
    the global ``lse`` and ``delta = rowsum(do * o)``. Batched (B, S)
    positions run B7 on 'cuda'."""
    if impl == "cuda":
        if not _batched(pos_q, pos_k):
            return _flash.flash_attention_bwd(
                q, k, v, do, lse, delta, pos_q, pos_k, causal=causal,
                window=window, scale=scale, prefix_len=prefix_len)
        return _ragged_bwd.flash_attention_bwd_ragged(
            q, k, v, do, lse, delta, pos_q, pos_k, causal=causal,
            window=window, scale=scale, prefix_len=prefix_len)
    return _ref.block_attention_bwd(
        q, k, v, do, lse, delta, pos_q, pos_k, causal=causal, window=window,
        scale=scale, prefix_len=prefix_len)


def prefill(q, k, v, pos_q, pos_k, *, causal=True, window=None, scale=None,
            prefix_len=None, impl="ref") -> torch.Tensor:
    """Full masked attention over a dense K/V set (o only, q's dtype)."""
    o, _ = block_fwd(q, k, v, pos_q, pos_k, causal=causal, window=window,
                     scale=scale, prefix_len=prefix_len, impl=impl)
    return o.to(q.dtype)


def decode(q, k, v, pos_q, pos_k, *, causal=True, window=None, scale=None,
           impl="ref"):
    """M-query attention vs a dense cache slice -> partial (o, lse);
    validity is position-encoded (unfilled slots sit past the query)."""
    return block_fwd(q, k, v, pos_q, pos_k, causal=causal, window=window,
                     scale=scale, impl=impl)


def paged_decode(q, pool_k, pool_v, table, cache_len, rank: int, *, sp: int,
                 page_size: int, window=None, scale=None, impl="ref"):
    """One query per row vs this shard's pages -> partial (o, lse).

    'cuda' runs B4 (``kernels/paged_decode.py``: on bf16 the tensor-core
    tile over the pages, its keys split over CTAs and merged in one
    launch); 'ref' gathers the pages into a dense view and reuses the plain
    oracle.
    """
    if impl == "cuda":
        return _paged.paged_decode_attention(
            q, pool_k, pool_v, table, cache_len, rank, sp=sp,
            page_size=page_size, window=window, scale=scale)
    return _paged.paged_decode_attention_plain(
        q, pool_k, pool_v, table, cache_len, rank, sp=sp,
        page_size=page_size, window=window, scale=scale)


def paged_prefill(q, pool_k, pool_v, table, cached_len, rank, *, sp: int,
                  page_size: int, window=None, scale=None, impl="ref"):
    """Suffix queries vs this shard's cached-prefix pages -> partial
    (o, lse): row b's query i sits at ``cached_len[b] + i`` and sees the
    keys at positions ``< cached_len[b]`` (strict: the suffix scores itself
    through ``block_fwd``).

    'cuda' runs B6 (``kernels/paged_prefill.py``: on bf16 the tensor-core
    tile, 64 packed (query, head) rows of a kv group per CTA, each page
    read once per group); 'ref' gathers the pages into a dense view and
    masks positionally.
    """
    if impl == "cuda":
        return _paged_pre.paged_prefill_attention(
            q, pool_k, pool_v, table, cached_len, rank, sp=sp,
            page_size=page_size, window=window, scale=scale)
    return _paged_pre.paged_prefill_attention_plain(
        q, pool_k, pool_v, table, cached_len, rank, sp=sp,
        page_size=page_size, window=window, scale=scale)
