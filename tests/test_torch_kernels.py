"""repro_torch kernel modules vs the JAX Pallas kernels (interpret mode).

The port's ``flash_attention_fwd`` (B1, and B2 with a running accumulator),
``flash_attention_bwd`` (B3), ``paged_decode_attention`` (B4) and
``flash_attention_bwd_ragged`` (B7) run their plain PyTorch versions on CPU
tensors; they are held against ``repro.kernels.flash_attention`` (B7: its
batched-positions route, ``_flash_attention_bwd_ragged``) and
``repro.kernels.paged_decode`` run with ``interpret=True``, as
``tests/test_kernels.py`` runs them. The prefix-LM mask (``prefix_len``)
is held the same way for B1, B2, B3, B5 (against
``repro.kernels.ragged_prefill``) and B7. Inputs are
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
from repro.kernels import ragged_prefill as jax_ragged
from repro_torch.core.combine import NEG_INF
from repro_torch.kernels import (dispatch, flash_attention, paged_decode,
                                 paged_prefill)
from repro_torch.kernels import ragged_bwd, ragged_prefill
from test_torch_gpu import (BWD_CASES, FWD_CASES, PAGED_CASES, PREFIX_CASES,
                            PREFIX_ROUTES, RAGGED_BWD_CASES, _assert_grads,
                            _assert_partials, _bwd_inputs, _fwd_inputs,
                            _paged_inputs, _prefix_inputs,
                            _ragged_bwd_inputs, _t)


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


@pytest.mark.parametrize("case", sorted(RAGGED_BWD_CASES))
def test_ragged_bwd_plain_matches_jax(case):
    """B7's plain version (and ``dispatch.block_bwd(impl='cuda')`` with
    (B, S) positions on CPU tensors) against the JAX flash backward with
    per-row positions in interpret mode."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, zero_row = RAGGED_BWD_CASES[case]
    arrs = _ragged_bwd_inputs(*RAGGED_BWD_CASES[case])
    want = jax_flash.flash_attention_bwd(
        *(jnp.asarray(x) for x in arrs), causal=causal, window=window,
        interpret=True)
    ragged_bwd.reset_launches()
    got = ragged_bwd.flash_attention_bwd_ragged(*(_t(x) for x in arrs),
                                                causal=causal, window=window)
    routed = dispatch.block_bwd(*(_t(x) for x in arrs), causal=causal,
                                window=window, impl="cuda")
    assert ragged_bwd.LAUNCHES == {"B7": 0}
    for a, b in zip(got, routed):
        assert torch.equal(a, b)
    _assert_grads([g.numpy() for g in got], want, arrs[4])
    if zero_row is not None:
        assert (arrs[4][zero_row] == np.float32(NEG_INF)).all()
        for g, w in zip(got, want):
            assert (g[zero_row] == 0).all()
            assert (np.asarray(w)[zero_row] == 0).all()


@pytest.mark.parametrize("route", PREFIX_ROUTES)
@pytest.mark.parametrize("case", sorted(PREFIX_CASES))
def test_prefix_lm_plain_matches_jax(case, route):
    """The plain versions under the prefix-LM mask (keys below prefix_len
    seen by every query), causal and windowed, against the Pallas kernels
    in interpret mode (50-row tiles, so some lie wholly inside the prefix):
    B1, B2 and B3 with shared (S,) positions, B5 and B7 with per-row
    (B, S) positions."""
    S, prefix_len, causal, window, D = PREFIX_CASES[case]
    arrs = _prefix_inputs(route, S, prefix_len, causal, window, D=D or 32)
    kw = dict(causal=causal, window=window, prefix_len=prefix_len)
    blk = dict(block_q=50, block_k=50, interpret=True)
    jx = [jnp.asarray(x) for x in arrs]
    tx = [_t(x) for x in arrs]
    if route in ("B3", "B7"):
        want = jax_flash.flash_attention_bwd(*jx, **kw, **blk)
        got = (flash_attention.flash_attention_bwd if route == "B3" else
               ragged_bwd.flash_attention_bwd_ragged)(*tx, **kw)
        _assert_grads([g.numpy() for g in got], want, arrs[4])
        return
    if route == "B5":
        want = jax_ragged.ragged_prefill_fwd(*jx, **kw, **blk)
        got = ragged_prefill.ragged_prefill_fwd(*tx, **kw)
    else:
        want = jax_flash.flash_attention_fwd(*jx, **kw, **blk)
        got = flash_attention.flash_attention_fwd(*tx, **kw)
    _assert_partials(got[0].numpy(), got[1].numpy(), *want)
    # the prefix is seen by every query: no row is dead
    assert (got[1] > NEG_INF / 2).all()


def test_paged_kernels_refuse_head_size_256():
    """No kernel refuses head size 256 any more: B4 and B6 check the same
    ``HEAD_DIMS`` as B1, B2, B3, B5 and B7 (256 among them), and their
    plain versions at 256 and pages of 128 run on the CPU; a head size
    outside ``HEAD_DIMS`` (48) raises in every kernel's check."""
    assert 256 in flash_attention.HEAD_DIMS
    assert not hasattr(flash_attention, "PAGED_HEAD_DIMS")
    for D in flash_attention.HEAD_DIMS:
        flash_attention.check_head_dim(D, flash_attention.HEAD_DIMS)
    with pytest.raises(ValueError, match="not in the kernel's"):
        flash_attention.check_head_dim(48, flash_attention.HEAD_DIMS)
    q, pool_k, pool_v, tbl, cl = _paged_inputs(2, 2, 2, 256, 128, 2, 1)
    o, lse = paged_decode.paged_decode_attention(
        _t(q), _t(pool_k), _t(pool_v), _t(tbl), _t(cl), 0, sp=1,
        page_size=128)
    assert o.shape == (2, 1, 2, 256) and bool(torch.isfinite(o).all())
    # B4 and B6 on meta tensors (their checks, no launch) at 256 and 48
    meta = torch.device("meta")
    args = [_t(x).to(meta) for x in (q, pool_k, pool_v, tbl, cl)]
    paged_decode.paged_decode_attention(*args, 0, sp=1, page_size=128)
    paged_prefill.paged_prefill_attention(*args, 0, sp=1, page_size=128)
    bad = [torch.empty(*x.shape[:-1], 48, device=meta) for x in args[:3]]
    for fn in (paged_decode.paged_decode_attention,
               paged_prefill.paged_prefill_attention):
        with pytest.raises(ValueError, match="not in the kernel's"):
            fn(*bad, *args[3:], 0, sp=1, page_size=128)
