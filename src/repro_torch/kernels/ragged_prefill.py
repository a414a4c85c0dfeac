"""Ragged block flash attention, B5 (``repro.kernels.ragged_prefill``):
``flash_attention_fwd`` with per-row ``(B, S)`` positions.

``ragged_prefill_fwd`` launches ``csrc/ragged_prefill.cu`` on CUDA tensors
and runs the plain PyTorch version (``ragged_prefill_fwd_plain``:
``ref.block_attention`` with batched positions) on CPU tensors. There is no
fallback: a CUDA tensor the kernel does not take raises. ``LAUNCHES``
counts the launches.

q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) in f32 or bf16; pos_q (B,Sq), pos_k (B,Sk)
int32 (a shared (S,) vector is broadcast over the batch, as in the JAX
wrapper); o (B,Sq,Hq,D) f32, lse (B,Hq,Sq) f32. Validity is positional: a
row whose keys all sit past its queries is dead and gives o = 0,
lse = -1e30 exactly.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import meta, ref
from repro_torch.kernels.flash_attention import (
    DTYPES, HEAD_DIMS, _check, check_head_dim)

LAUNCHES: Dict[str, int] = {"B5": 0}


def reset_launches() -> None:
    LAUNCHES["B5"] = 0


def _batched(pos, B: int) -> torch.Tensor:
    pos = pos.to(torch.int32)
    if pos.dim() == 1:
        pos = pos[None].expand(B, -1)
    return pos.contiguous()


def ragged_prefill_fwd_plain(q, k, v, pos_q, pos_k, *, causal=True,
                             window=None, scale=None, prefix_len=None):
    """The plain version: ``ref.block_attention`` with (B, S) positions."""
    B = q.shape[0]
    return ref.block_attention(q, k, v, _batched(pos_q, B),
                               _batched(pos_k, B), causal=causal,
                               window=window, scale=scale,
                               prefix_len=prefix_len)


def ragged_prefill_fwd(q, k, v, pos_q, pos_k, *, causal=True,
                       window: Optional[int] = None,
                       scale: Optional[float] = None,
                       prefix_len: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched-positions block flash attention -> (o, lse), the semantics
    of ``ref.block_attention`` (kernel B5 on CUDA tensors)."""
    if q.device.type == "cpu":
        return ragged_prefill_fwd_plain(q, k, v, pos_q, pos_k, causal=causal,
                                        window=window, scale=scale,
                                        prefix_len=prefix_len)
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
    _check("pos_q", pos_q, (B, Sq), (torch.int32,), dev)
    _check("pos_k", pos_k, (B, Sk), (torch.int32,), dev)
    o = torch.empty((B, Sq, Hq, D), dtype=torch.float32, device=dev)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    if q.is_meta:
        return meta.charge(
            "B5", meta.attention_flops(q, Sk),
            meta.io_bytes(q, k, v, pos_q, pos_k, o, lse), (o, lse))
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    lib = _build.library()
    err = lib.repro_ragged_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_q.data_ptr(),
        pos_k.data_ptr(), o.data_ptr(), lse.data_ptr(), B, Sq, Sk, Hq, Hkv,
        D, DTYPES[q.dtype], int(bool(causal)), int(window is not None),
        int(window or 0), int(prefix_len is not None), int(prefix_len or 0),
        float(scale), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ragged_prefill")
    LAUNCHES["B5"] += 1
    return o, lse
