"""Ragged block flash-attention backward, B7
(``repro.kernels.flash_attention._flash_attention_bwd_ragged``): the flash
backward B3 with per-row ``(B, S)`` positions.

``flash_attention_bwd_ragged`` launches ``csrc/ragged_bwd.cu`` on CUDA
tensors and runs the plain PyTorch version
(``flash_attention_bwd_ragged_plain``: ``ref.block_attention_bwd`` with
batched positions) on CPU tensors. There is no fallback: a CUDA tensor the
kernel does not take raises. ``LAUNCHES`` counts the wrapper calls that
launched it (one call is two kernel launches: dq, then dk/dv).

q, do (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) in f32 or bf16; pos_q (B,Sq), pos_k
(B,Sk) int32 (a shared (S,) vector is broadcast over the batch, as in the
JAX wrapper); lse, delta (B,Hq,Sq) f32 (the *global* lse and
``delta = rowsum(do * o)``); dq, dk, dv f32 in the shapes of q, k, v. A row
whose lse is dead (-1e30: a zero-length row) gives dq = 0 exactly and adds
nothing to dk and dv.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import meta, ref
from repro_torch.kernels.flash_attention import (
    DTYPES, HEAD_DIMS, _check, check_head_dim)
from repro_torch.kernels.ragged_prefill import _batched

LAUNCHES: Dict[str, int] = {"B7": 0}


def reset_launches() -> None:
    LAUNCHES["B7"] = 0


def flash_attention_bwd_ragged_plain(q, k, v, do, lse, delta, pos_q, pos_k,
                                     *, causal=True, window=None,
                                     scale=None, prefix_len=None):
    """The plain version: ``ref.block_attention_bwd`` with (B, S)
    positions."""
    B = q.shape[0]
    return ref.block_attention_bwd(q, k, v, do, lse, delta,
                                   _batched(pos_q, B), _batched(pos_k, B),
                                   causal=causal, window=window, scale=scale,
                                   prefix_len=prefix_len)


def flash_attention_bwd_ragged(q, k, v, do, lse, delta, pos_q, pos_k, *,
                               causal=True, window: Optional[int] = None,
                               scale: Optional[float] = None,
                               prefix_len: Optional[int] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Batched-positions flash backward for one (Q x K/V) block pair ->
    (dq, dk, dv) in f32, the semantics of ``ref.block_attention_bwd``
    (kernel B7 on CUDA tensors)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ragged_plain(
            q, k, v, do, lse, delta, pos_q, pos_k, causal=causal,
            window=window, scale=scale, prefix_len=prefix_len)
    from repro_torch.kernels import _build

    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    check_head_dim(D, HEAD_DIMS)
    dev = q.device
    pos_q, pos_k = _batched(pos_q, B), _batched(pos_k, B)
    _check("q", q, (B, Sq, Hq, D), DTYPES, dev)
    _check("k", k, (B, Sk, Hkv, D), (q.dtype,), dev)
    _check("v", v, (B, Sk, Hkv, D), (q.dtype,), dev)
    _check("do", do, (B, Sq, Hq, D), (q.dtype,), dev)
    _check("lse", lse, (B, Hq, Sq), (torch.float32,), dev)
    _check("delta", delta, (B, Hq, Sq), (torch.float32,), dev)
    _check("pos_q", pos_q, (B, Sq), (torch.int32,), dev)
    _check("pos_k", pos_k, (B, Sk), (torch.int32,), dev)
    dq = torch.empty((B, Sq, Hq, D), dtype=torch.float32, device=dev)
    dk = torch.empty((B, Sk, Hkv, D), dtype=torch.float32, device=dev)
    dv = torch.empty((B, Sk, Hkv, D), dtype=torch.float32, device=dev)
    if q.is_meta:
        return meta.charge(
            "B7", meta.attention_flops(q, Sk, 10),
            meta.io_bytes(q, k, v, do, lse, delta, pos_q, pos_k, dq, dk, dv),
            (dq, dk, dv))
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    lib = _build.library()
    err = lib.repro_ragged_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), pos_q.data_ptr(), pos_k.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, Hq, Hkv, D,
        DTYPES[q.dtype], int(bool(causal)), int(window is not None),
        int(window or 0), int(prefix_len is not None), int(prefix_len or 0),
        float(scale), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ragged_bwd")
    LAUNCHES["B7"] += 1
    return dq, dk, dv
