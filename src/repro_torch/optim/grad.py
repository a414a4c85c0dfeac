"""Gradient compression (the port's counterpart of ``repro.optim.grad``).

int8 quantisation with a per-tensor scale, optional stochastic rounding,
and an error-feedback buffer (1-bit-Adam style). On a multi-pod deployment
the compressed form is what crosses the slow link; here the round trip is
applied by ``train.step.build_train_step`` when
``run_cfg.grad_compression == 'int8'``, as in the JAX package.

The arithmetic is the JAX package's op for op in float32 (the division
order, and round half to even in both ``jnp.round`` and ``torch.round``),
so the deterministic path gives the same bits. Stochastic rounding draws
its uniforms from an explicit ``torch.Generator`` in place of a JAX key:
the two give different numbers from one seed, so only its distribution is
comparable.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch


def quantize_int8(x: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantisation -> (int8 values, f32 scale);
    stochastic rounding when ``generator`` is given (on x's device).
    ``amax`` is the tensor's max |value| when ``x`` is a shard of it
    (default: x's own)."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().max()
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    y = xf / scale
    if generator is not None:
        y = torch.floor(y + torch.rand(y.shape, generator=generator,
                                       device=y.device))
    else:
        y = torch.round(y)
    return torch.clamp(y, -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def shard_amax(grads: Sequence[torch.Tensor],
               leaves: Sequence[int]) -> Dict[int, torch.Tensor]:
    """Each leaf's max |value| over the shards of it in ``grads``
    (``leaves[i]`` the leaf ``grads[i]`` is a shard of)."""
    amax: Dict[int, torch.Tensor] = {}
    for g, k in zip(grads, leaves):
        m = g.float().abs().max()
        amax[k] = m if k not in amax else torch.maximum(amax[k], m)
    return amax


def int8_roundtrip(grads: Sequence[torch.Tensor],
                   leaves: Optional[Sequence[int]] = None,
                   amax: Optional[Mapping[int, torch.Tensor]] = None
                   ) -> List[torch.Tensor]:
    """The compressed reduction's values (deterministic rounding), each in
    its gradient's dtype. ``leaves[i]`` names the leaf ``grads[i]`` is a
    shard of (default: every gradient a whole leaf): the scale of each
    leaf is taken over all of its shards, as the JAX round trip takes it
    over the global array; ``amax`` gives each leaf's max |value| where
    ``grads`` do not hold all of its shards (a rank process's, taken as a
    ``pmax`` over the mesh; default: ``shard_amax`` of ``grads``)."""
    leaves = range(len(grads)) if leaves is None else leaves
    if amax is None:
        amax = shard_amax(grads, leaves)
    out = []
    for g, k in zip(grads, leaves):
        q, s = quantize_int8(g, amax=amax[k])
        out.append(dequantize_int8(q, s).to(g.dtype))
    return out


def error_feedback_compress(grads: Sequence[torch.Tensor],
                            residual: Sequence[torch.Tensor]
                            ) -> Tuple[List[torch.Tensor],
                                       List[torch.Tensor]]:
    """Compress grads + residual -> (decompressed, new residual). The
    residual carries the quantisation error into the next step, so the
    compressed trajectory converges to the uncompressed one."""
    dec, res = [], []
    for g, r in zip(grads, residual):
        t = g.float() + r
        q, s = quantize_int8(t)
        d = dequantize_int8(q, s)
        dec.append(d.to(g.dtype))
        res.append(t - d)
    return dec, res


def zeros_like_residual(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for g in grads]
