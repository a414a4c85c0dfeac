"""Differentiable full-sequence attention over the dispatch layer: the
port's counterpart of ``repro.kernels.ops.flash_attention`` and its custom
VJP (``_fa_fwd`` / ``_fa_bwd``).

``FlashAttention`` is a ``torch.autograd.Function``: its forward is
``dispatch.block_fwd`` (kernel B1 on CUDA tensors under ``impl='cuda'``),
keeping the f32 ``(o, lse)``; its backward computes
``delta = rowsum(do * o)`` in f32 from that o, as ``_fa_bwd`` does, then
``dispatch.block_bwd`` (kernel B3). ``dispatch.prefill`` stays o-only for
serving; DeepSpeed-Ulysses (``core.ulysses``) trains through this
Function. The StarTrail ring keeps its own residuals across ring steps and
calls the kernels directly.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) under the positional mask, in q's dtype;
    the gradients come back in the input dtypes. Residuals are kept only
    when an input needs a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, pos_q, pos_k, causal, window, scale,
                prefix_len, impl):
        mask = dict(causal=causal, window=window, scale=scale,
                    prefix_len=prefix_len, impl=impl)
        o, lse = dispatch.block_fwd(q, k, v, pos_q, pos_k, **mask)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, pos_q, pos_k, o, lse)
            ctx.mask = mask
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, pos_q, pos_k, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = torch.einsum("bshd,bshd->bhs", do.float(),
                             o.float()).contiguous()
        dq, dk, dv = dispatch.block_bwd(q, k, v, do, lse, delta, pos_q,
                                        pos_k, **ctx.mask)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None, None)


def flash_attention(q, k, v, pos_q, pos_k, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None,
                    prefix_len: Optional[int] = None,
                    impl: str = "cuda") -> torch.Tensor:
    """Differentiable masked attention of q (B, Sq, Hq, D) against k, v
    (B, Sk, Hkv, D) at positions pos_q (Sq,), pos_k (Sk,) -> o in q's
    dtype (``FlashAttention.apply``)."""
    return FlashAttention.apply(q, k, v, pos_q, pos_k, causal, window,
                                scale, prefix_len, impl)
