"""The single attention-kernel dispatch layer of the port (mirrors
``repro.kernels.dispatch``).

Every attention call site in ``core/``, ``serve/`` and ``models/`` goes
through this module. One ``impl`` knob selects the backend:

  'ref'   plain PyTorch (``kernels.ref``) on any device
  'cuda'  the hand-written kernels: ``flash_attention_fwd`` (B1/B2),
          ``flash_attention_bwd`` (B3) and ``paged_decode_attention`` (B4).
          On CUDA tensors they launch the kernel or raise; on CPU tensors
          they run their plain version.

Entry points:
    block_fwd / block_fwd_merge  one (Q block x K/V block) pair of a ring
                                 step; the merge form folds the block into
                                 the running (o_acc, lse_acc), fused into
                                 the B2 epilogue on 'cuda'
    block_bwd                    the flash backward of one block pair (B3)
    prefill                      full masked attention (o only, q's dtype)
    decode                       per-shard partial (o, lse) of M queries vs
                                 a dense cache slice
    paged_decode                 per-shard partial (o, lse) straight off a
                                 page-table-indexed pool

Batched (B, S) positions need the ragged kernels B5 (forward) and B7
(backward), which are not ported (ROADMAP §B): 'cuda' raises on CUDA
tensors there; 'ref' serves them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.combine import combine_pair
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_decode as _paged
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


_RAGGED = {
    "block_fwd": "the ragged prefill kernel B5 "
                 "(repro/kernels/ragged_prefill.py)",
    "block_bwd": "the ragged backward kernel B7 (repro/kernels/"
                 "flash_attention.py:_flash_attention_bwd_ragged)",
}


def _no_ragged_kernel(q, entry: str) -> None:
    if q.is_cuda:
        raise NotImplementedError(
            f"dispatch.{entry}(impl='cuda') with batched (B, S) positions "
            f"needs {_RAGGED[entry]}, not ported yet: ROADMAP §B")


def block_fwd(q, k, v, pos_q, pos_k, *, causal=True, window=None, scale=None,
              prefix_len=None, impl="ref") -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked (Q block x K/V block) attention -> (o, lse) partials."""
    if impl == "cuda":
        if not _batched(pos_q, pos_k):
            return _flash.flash_attention_fwd(
                q, k, v, pos_q, pos_k, causal=causal, window=window,
                scale=scale, prefix_len=prefix_len)
        _no_ragged_kernel(q, "block_fwd")
    return _ref.block_attention(q, k, v, pos_q, pos_k, causal=causal,
                                window=window, scale=scale,
                                prefix_len=prefix_len)


def block_fwd_merge(q, k, v, o_acc, lse_acc, pos_q, pos_k, *, causal=True,
                    window=None, scale=None, prefix_len=None, impl="ref"):
    """One ring step: ``combine_pair(o_acc, lse_acc, *block_fwd(...))``,
    the combine fused into the B2 kernel epilogue on 'cuda'."""
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
    the global ``lse`` and ``delta = rowsum(do * o)``."""
    if impl == "cuda":
        if not _batched(pos_q, pos_k):
            return _flash.flash_attention_bwd(
                q, k, v, do, lse, delta, pos_q, pos_k, causal=causal,
                window=window, scale=scale, prefix_len=prefix_len)
        _no_ragged_kernel(q, "block_bwd")
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

    'cuda' runs B4 (``kernels/paged_decode.py``); 'ref' gathers the pages
    into a dense view and reuses the plain oracle.
    """
    if impl == "cuda":
        return _paged.paged_decode_attention(
            q, pool_k, pool_v, table, cache_len, rank, sp=sp,
            page_size=page_size, window=window, scale=scale)
    return _paged.paged_decode_attention_plain(
        q, pool_k, pool_v, table, cache_len, rank, sp=sp,
        page_size=page_size, window=window, scale=scale)
