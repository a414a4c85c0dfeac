"""Block flash attention of ``repro.kernels.flash_attention``: the forward
B1 (``_fwd_kernel``) and B2 (the fused ring-merge ``_fwd_merge_kernel``),
and the backward B3 (``_bwd_dq_kernel`` + ``_bwd_dkv_kernel``).

``flash_attention_fwd`` launches ``csrc/flash_fwd.cu`` and
``flash_attention_bwd`` launches ``csrc/flash_bwd.cu`` on CUDA tensors; on
CPU tensors they run their plain PyTorch versions
(``flash_attention_fwd_plain``: the ``ref.block_attention`` oracle, then
``combine_pair`` for B2; ``flash_attention_bwd_plain``:
``ref.block_attention_bwd``). There is no fallback: a CUDA tensor a kernel
does not take raises. ``LAUNCHES`` counts the wrapper calls that launched a
kernel (B1, B2 and B3 apart; one B3 call is two kernel launches).

Layouts are the JAX package's: q, do (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) in f32
or bf16; pos_q (Sq,), pos_k (Sk,) int32; o (B,Sq,Hq,D) f32; lse, delta
(B,Hq,Sq) f32; dq, dk, dv f32 in the shapes of q, k, v.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.combine import combine_pair
from repro_torch.kernels import ref

HEAD_DIMS = (32, 64, 80, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {"B1": 0, "B2": 0, "B3": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_attention_fwd_plain(q, k, v, pos_q, pos_k, o_acc=None,
                              lse_acc=None, *, causal=True, window=None,
                              scale=None, prefix_len=None):
    """The plain version: ``block_attention`` (+ ``combine_pair`` for B2)."""
    o, lse = ref.block_attention(q, k, v, pos_q, pos_k, causal=causal,
                                 window=window, scale=scale,
                                 prefix_len=prefix_len)
    if o_acc is None:
        return o, lse
    return combine_pair(o_acc, lse_acc, o, lse)


def flash_attention_bwd_plain(q, k, v, do, lse, delta, pos_q, pos_k, *,
                              causal=True, window=None, scale=None,
                              prefix_len=None):
    """The plain version of B3: ``ref.block_attention_bwd``."""
    return ref.block_attention_bwd(q, k, v, do, lse, delta, pos_q, pos_k,
                                   causal=causal, window=window, scale=scale,
                                   prefix_len=prefix_len)


def _check(name, t, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_block(q, k, v, pos_q, pos_k):
    """Check the (Q block x K/V block) inputs a kernel takes on the card;
    returns (B, Sq, Hq, D, Sk, Hkv)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in the kernel's {HEAD_DIMS}")
    dev = q.device
    dts = (q.dtype,)
    _check("q", q, (B, Sq, Hq, D), DTYPES, dev)
    _check("k", k, (B, Sk, Hkv, D), dts, dev)
    _check("v", v, (B, Sk, Hkv, D), dts, dev)
    _check("pos_q", pos_q, (Sq,), (torch.int32,), dev)
    _check("pos_k", pos_k, (Sk,), (torch.int32,), dev)
    return B, Sq, Hq, D, Sk, Hkv


def flash_attention_fwd(q, k, v, pos_q, pos_k, o_acc=None, lse_acc=None, *,
                        causal=True, window: Optional[int] = None,
                        scale: Optional[float] = None,
                        prefix_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block flash attention -> (o, lse), same semantics as
    ``ref.block_attention``. With ``(o_acc, lse_acc)`` (the running ring
    accumulator, (B,Sq,Hq,D) / (B,Hq,Sq) f32) the result is
    ``combine_pair(o_acc, lse_acc, *flash_attention_fwd(...))`` with the
    merge fused into the kernel epilogue (B2)."""
    if (o_acc is None) != (lse_acc is None):
        raise ValueError("o_acc and lse_acc must be passed together")
    if not q.is_cuda:
        return flash_attention_fwd_plain(
            q, k, v, pos_q, pos_k, o_acc, lse_acc, causal=causal,
            window=window, scale=scale, prefix_len=prefix_len)
    from repro_torch.kernels import _build

    B, Sq, Hq, D, Sk, Hkv = _check_block(q, k, v, pos_q, pos_k)
    dev = q.device
    merge = o_acc is not None
    if merge:
        _check("o_acc", o_acc, (B, Sq, Hq, D), (torch.float32,), dev)
        _check("lse_acc", lse_acc, (B, Hq, Sq), (torch.float32,), dev)
    o = torch.empty((B, Sq, Hq, D), dtype=torch.float32, device=dev)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    lib = _build.library()
    err = lib.repro_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_q.data_ptr(),
        pos_k.data_ptr(), o_acc.data_ptr() if merge else None,
        lse_acc.data_ptr() if merge else None, o.data_ptr(), lse.data_ptr(),
        B, Sq, Sk, Hq, Hkv, D, DTYPES[q.dtype], int(bool(causal)),
        int(window is not None), int(window or 0),
        int(prefix_len is not None), int(prefix_len or 0), float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_fwd")
    LAUNCHES["B2" if merge else "B1"] += 1
    return o, lse


def flash_attention_bwd(q, k, v, do, lse, delta, pos_q, pos_k, *,
                        causal=True, window: Optional[int] = None,
                        scale: Optional[float] = None,
                        prefix_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash backward for one (Q x K/V) block pair from the *global* lse
    and ``delta = rowsum(do * o)`` -> (dq, dk, dv) in f32, the semantics of
    ``ref.block_attention_bwd`` (kernel B3 on CUDA tensors)."""
    if not q.is_cuda:
        return flash_attention_bwd_plain(
            q, k, v, do, lse, delta, pos_q, pos_k, causal=causal,
            window=window, scale=scale, prefix_len=prefix_len)
    from repro_torch.kernels import _build

    B, Sq, Hq, D, Sk, Hkv = _check_block(q, k, v, pos_q, pos_k)
    dev = q.device
    _check("do", do, (B, Sq, Hq, D), (q.dtype,), dev)
    _check("lse", lse, (B, Hq, Sq), (torch.float32,), dev)
    _check("delta", delta, (B, Hq, Sq), (torch.float32,), dev)
    dq = torch.empty((B, Sq, Hq, D), dtype=torch.float32, device=dev)
    dk = torch.empty((B, Sk, Hkv, D), dtype=torch.float32, device=dev)
    dv = torch.empty((B, Sk, Hkv, D), dtype=torch.float32, device=dev)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    lib = _build.library()
    err = lib.repro_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), pos_q.data_ptr(), pos_k.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, Hq, Hkv, D,
        DTYPES[q.dtype], int(bool(causal)), int(window is not None),
        int(window or 0), int(prefix_len is not None), int(prefix_len or 0),
        float(scale), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_bwd")
    LAUNCHES["B3"] += 1
    return dq, dk, dv
