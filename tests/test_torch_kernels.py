"""repro_torch kernel modules vs the JAX Pallas kernels (interpret mode).

The port's ``flash_attention_fwd`` (B1, and B2 with a running accumulator),
``flash_attention_bwd`` (B3) and ``paged_decode_attention`` (B4) run their
plain PyTorch versions on CPU tensors; they are held against
``repro.kernels.flash_attention`` and ``repro.kernels.paged_decode`` run
with ``interpret=True``, as ``tests/test_kernels.py`` runs them. Inputs are
made with numpy from a seed and handed to both packages. Tolerance 2e-5 in
f32 for the forward kernels (the JAX kernel tests' own) and 3e-4 for the
backward (``test_bwd_matches_ref``'s); dead rows (no visible key) must be
exact: o = 0, lse = -1e30, dq = 0.

The CUDA kernels are held against these plain versions on the card in
``tests/test_torch_gpu.py``, which shares this file's case tables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro.kernels import paged_decode as jax_paged
from repro_torch.core.combine import NEG_INF
from repro_torch.kernels import flash_attention, paged_decode
from test_torch_gpu import (BWD_CASES, FWD_CASES, PAGED_CASES,
                            _assert_grads, _assert_partials, _bwd_inputs,
                            _fwd_inputs, _paged_inputs, _t)


@pytest.mark.parametrize("merge", [False, True], ids=["B1", "B2"])
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_flash_fwd_plain_matches_jax(case, merge):
    B, S, Hq, Hkv, D, causal, window, kind, blk = FWD_CASES[case]
    q, k, v, pos_q, pos_k = _fwd_inputs(B, S, Hq, Hkv, D, kind)
    acc = {}
    if merge:
        rng = np.random.default_rng(1)
        o_acc = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
        lse_acc = rng.normal(size=(B, Hq, S)).astype(np.float32)
        # some rows of the running accumulator have seen nothing yet
        lse_acc[:, :, : S // 4] = NEG_INF
        o_acc[:, : S // 4] = 0.0
        acc = dict(o_acc=o_acc, lse_acc=lse_acc)
    o_j, lse_j = jax_flash.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos_q),
        jnp.asarray(pos_k), *(jnp.asarray(acc[n]) for n in acc),
        causal=causal, window=window, block_q=blk, block_k=blk,
        interpret=True)
    flash_attention.reset_launches()
    o_t, lse_t = flash_attention.flash_attention_fwd(
        _t(q), _t(k), _t(v), _t(pos_q), _t(pos_k),
        *(_t(acc[n]) for n in acc), causal=causal, window=window)
    # CPU tensors run the plain version: no kernel launch is counted
    assert flash_attention.LAUNCHES == {"B1": 0, "B2": 0, "B3": 0}
    _assert_partials(o_t.numpy(), lse_t.numpy(), o_j, lse_j)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_plain_matches_jax(case):
    B, Sq, Sk, Hq, Hkv, D, causal, window, kind, blk = BWD_CASES[case]
    arrs = _bwd_inputs(B, Sq, Sk, Hq, Hkv, D, causal, window, kind)
    want = jax_flash.flash_attention_bwd(
        *(jnp.asarray(x) for x in arrs), causal=causal, window=window,
        block_q=blk, block_k=blk, interpret=True)
    flash_attention.reset_launches()
    got = flash_attention.flash_attention_bwd(*(_t(x) for x in arrs),
                                              causal=causal, window=window)
    assert flash_attention.LAUNCHES == {"B1": 0, "B2": 0, "B3": 0}
    if kind == "future":
        assert (arrs[4] <= NEG_INF / 2).any()      # there are dead rows
    _assert_grads([g.numpy() for g in got], want, arrs[4])


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_decode_plain_matches_jax(case):
    B, Hq, Hkv, D, ps, W, sp, rank, window = PAGED_CASES[case]
    q, pool_k, pool_v, tbl, cl = _paged_inputs(B, Hq, Hkv, D, ps, W, sp)
    o_j, lse_j = jax_paged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(tbl), jnp.asarray(cl), jnp.int32(rank), sp=sp,
        page_size=ps, window=window, interpret=True)
    paged_decode.reset_launches()
    o_t, lse_t = paged_decode.paged_decode_attention(
        _t(q), _t(pool_k), _t(pool_v), _t(tbl), _t(cl), rank, sp=sp,
        page_size=ps, window=window)
    assert paged_decode.LAUNCHES == {"B4": 0}
    _assert_partials(o_t.numpy(), lse_t.numpy(), o_j, lse_j)
    # the inactive slot is dead on every head
    assert (lse_t[-1].numpy() == np.float32(NEG_INF)).all()
