"""The arithmetic of the bf16 tensor-core backward (B3, B7), emulated in
plain PyTorch on the CPU and held against the JAX flash backward.

On bf16 inputs the kernels of ``src/repro_torch/csrc/flash_bwd.cuh``
multiply on the tensor cores: q k^T and dO v^T are exact products of bf16
values summed in f32, and P and dS, which are f32, enter the dV, dK and dQ
products as a bf16 hi/lo pair (hi = bf16(x), lo = bf16(x - hi), two MMAs),
with ``scale`` applied to dq and dk once at the end and
p = exp2(s * scale * log2 e - lse * log2 e). ``emulated_bwd`` does the
same in f32 on the CPU. One bf16 rounding of P and dS would miss the 3e-4
bound of the JAX ``test_bwd_matches_ref`` by about 10×; the pair must stay
within it for every case of ``BWD_CASES`` (shared (S,) positions, B3) and
``RAGGED_BWD_CASES`` (per-row positions, B7), against
``repro.kernels.flash_attention.flash_attention_bwd`` run in interpret mode
on the same bf16-rounded inputs. Dead rows give dq = 0 exactly, and a
zero-length row gives dq, dk, dv = 0 exactly. The emulation sums in f32
with rounding to nearest; the tensor cores' accumulation truncates, which
the kernels contain by summing each tile's share apart, and which only the
card shows (``tests/test_torch_gpu.py``, where the kernel itself runs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro_torch.core.combine import NEG_INF
from repro_torch.kernels import flash_attention, ref
from test_torch_gpu import (BWD_CASES, RAGGED_BWD_CASES, _assert_grads,
                            _bwd_inputs, _ragged_bwd_inputs)

LOG2E = 1.4426950408889634


def _split(x):
    """x as a bf16 hi/lo pair, each returned in f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def emulated_bwd(q, k, v, do, lse, delta, pos_q, pos_k, *, causal, window):
    """(dq, dk, dv) as the tensor-core kernels compute them: f32 tensors
    holding bf16 values in, f32 sums, P and dS as hi/lo pairs."""
    B, Sq, Hq, D = q.shape
    G = Hq // k.shape[2]
    scale = 1.0 / D ** 0.5
    kx, vx = (t.repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kx)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vx)
    mask = ref.make_mask(pos_q, pos_k, causal=causal, window=window)
    if mask is None:                # no mask: every pair visible
        mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool)
    mask = mask[None, None] if mask.dim() == 2 else mask[:, None]
    nlse = torch.where(lse <= NEG_INF / 2, -torch.inf,
                       -lse * np.float32(LOG2E))
    p = torch.where(mask, torch.exp2(s * np.float32(scale * LOG2E)
                                     + nlse[..., None]), 0.0)
    ds = p * (dp - delta[..., None])
    (ph, pl), (dsh, dsl) = _split(p), _split(ds)
    dq = torch.einsum("bhqk,bkhd->bqhd", dsh, kx) \
        + torch.einsum("bhqk,bkhd->bqhd", dsl, kx)
    dk = torch.einsum("bhqk,bqhd->bkhd", dsh, q) \
        + torch.einsum("bhqk,bqhd->bkhd", dsl, q)
    dv = torch.einsum("bhqk,bqhd->bkhd", ph, do) \
        + torch.einsum("bhqk,bqhd->bkhd", pl, do)
    # the G query heads of a kv head add into its dk and dv
    dk, dv = (t.reshape(B, -1, Hq // G, G, D).sum(3) for t in (dk, dv))
    return dq * scale, dk * scale, dv


def _bf16(arrs):
    """q, k, v, do rounded to bf16 (kept as f32 numpy); the rest as is."""
    return [torch.from_numpy(x).bfloat16().float().numpy()
            for x in arrs[:4]] + list(arrs[4:])


def _check(arrs, causal, window, blk=None):
    want = jax_flash.flash_attention_bwd(
        *(jnp.asarray(x) for x in arrs), causal=causal, window=window,
        **({} if blk is None else dict(block_q=blk, block_k=blk)),
        interpret=True)
    got = emulated_bwd(*(torch.from_numpy(np.ascontiguousarray(x))
                         for x in arrs), causal=causal, window=window)
    _assert_grads([g.numpy() for g in got], want, arrs[4])
    return got


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_split_bwd_matches_jax(case):
    B, Sq, Sk, Hq, Hkv, D, causal, window, kind, blk = BWD_CASES[case]
    if D not in flash_attention.HEAD_DIMS:
        D = 32                      # the head sizes the kernel takes
    arrs = _bf16(_bwd_inputs(B, Sq, Sk, Hq, Hkv, D, causal, window, kind))
    _check(arrs, causal, window, blk)
    if kind == "future":
        assert (arrs[4] <= NEG_INF / 2).any()      # there are dead rows


@pytest.mark.parametrize("case", sorted(RAGGED_BWD_CASES))
def test_split_bwd_ragged_matches_jax(case):
    causal, window, zero_row = RAGGED_BWD_CASES[case][6:]
    arrs = _bf16(_ragged_bwd_inputs(*RAGGED_BWD_CASES[case]))
    got = _check(arrs, causal, window)
    if zero_row is not None:
        assert all(bool((g[zero_row] == 0).all()) for g in got)
