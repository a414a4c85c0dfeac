"""repro_torch's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips from inside the
``cuda_device`` fixture when ``torch.cuda.is_available()`` is false (never
at import or collection, so every pytest-xdist worker collects the same
tests). The file imports no JAX: the machine with the card has none. Run on
the card with ``python -m pytest -q -m gpu tests/test_torch_gpu.py``.

The case tables and input builders are shared with
``tests/test_torch_kernels.py``, which holds the plain versions against the
JAX Pallas kernels on the CPU. Tolerances: forward 2e-5 for f32 inputs (the
JAX kernel tests' own), 1e-4 for bf16 inputs upcast to f32 in both versions
(only the summation order differs); backward (B3) 3e-4, the JAX
``test_bwd_matches_ref`` bound; dead rows exact.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import startrail as st_torch
from repro_torch.core.combine import NEG_INF
from repro_torch.kernels import flash_attention, paged_decode

TOL = 2e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _zigzag(rank, n, p):
    return st_torch.shard_positions(rank, n, p, "zigzag").numpy()


def _assert_partials(o, lse, o_ref, lse_ref, tol=TOL):
    o, lse = np.asarray(o), np.asarray(lse)
    o_ref, lse_ref = np.asarray(o_ref), np.asarray(lse_ref)
    np.testing.assert_allclose(o, o_ref, atol=tol, rtol=tol)
    live = lse_ref > NEG_INF / 2
    np.testing.assert_allclose(lse[live], lse_ref[live], atol=tol, rtol=tol)
    # dead rows: exact zeros and exactly NEG_INF
    assert (lse[~live] == np.float32(NEG_INF)).all()
    dead_o = np.swapaxes(~live, 1, 2)                  # (B, S, H)
    assert (o[dead_o] == 0.0).all()


FWD_CASES = {
    # B, S, Hq, Hkv, D, causal, window, positions, blk
    "mha_causal_d16": (2, 64, 2, 2, 16, True, None, "arange", 32),
    "gqa_window_d80": (1, 64, 8, 2, 80, True, 24, "arange", 32),
    "gqa_full_d16": (1, 64, 8, 2, 16, False, None, "arange", 32),
    "dead_rows": (1, 64, 4, 1, 16, True, None, "future", 32),
    "zigzag_gqa": (1, 64, 8, 2, 80, True, 40, "zigzag", 32),
}


def _fwd_inputs(B, S, Hq, Hkv, D, kind, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    ar = np.arange(S, dtype=np.int32)
    if kind == "arange":
        pos_q, pos_k = ar, ar
    elif kind == "future":
        # the first half of the query rows see no key at all
        pos_q, pos_k = ar, ar + S // 2
    else:
        pos_q, pos_k = _zigzag(1, 2 * S, 2), _zigzag(0, 2 * S, 2)
    return q, k, v, pos_q.astype(np.int32), pos_k.astype(np.int32)


PAGED_CASES = {
    # B, Hq, Hkv, D, ps, W, sp, rank, window
    "mha_d16": (3, 2, 2, 16, 4, 4, 1, 0, None),
    "gqa_d80": (3, 8, 2, 80, 4, 4, 1, 0, None),
    "gqa_window": (3, 8, 2, 16, 4, 5, 1, 0, 6),
    "sp2_rank1": (3, 8, 2, 80, 4, 3, 2, 1, None),
    "sp2_rank1_window": (3, 4, 1, 16, 4, 3, 2, 1, 7),
}


def _paged_inputs(B, Hq, Hkv, D, ps, W, sp, seed=0):
    rng = np.random.default_rng(seed)
    pages_loc = 8
    pool_k = rng.normal(size=(pages_loc, ps, Hkv, D)).astype(np.float32)
    pool_v = rng.normal(size=(pages_loc, ps, Hkv, D)).astype(np.float32)
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    tbl = rng.integers(0, pages_loc, size=(B, W)).astype(np.int32)
    tbl[0, -1] = -1                                  # unallocated tail page
    # row 0: a partial last page; row 1: anywhere
    cl = np.array([(W * sp - 2) * ps + ps // 2,
                   rng.integers(0, W * sp * ps)] + [0] * (B - 2), np.int32)
    tbl[-1] = -1                                     # an inactive slot
    cl[-1] = 0
    return q, pool_k, pool_v, tbl, cl


BWD_TOL = 3e-4

BWD_CASES = {
    # B, Sq, Sk, Hq, Hkv, D, causal, window, positions, blk
    "mha_causal_d16": (2, 64, 64, 2, 2, 16, True, None, "arange", 32),
    "gqa4_window_d80": (1, 64, 64, 8, 2, 80, True, 24, "arange", 32),
    "gqa4_full_d16": (1, 64, 64, 8, 2, 16, False, None, "arange", 32),
    "dead_rows": (1, 64, 64, 4, 1, 16, True, None, "future", 32),
    "zigzag_gqa4": (1, 64, 64, 8, 2, 80, True, 40, "zigzag", 32),
    "sq_ne_sk": (1, 64, 128, 8, 2, 16, True, None, "offset", 32),
}


def _bwd_inputs(B, Sq, Sk, Hq, Hkv, D, causal, window, kind, seed=0):
    """q, k, v, do, positions, and the *global* lse and delta =
    rowsum(do * o) of full attention over the block pair (from the plain
    forward), all numpy f32 / int32."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    do = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    if kind == "zigzag":
        pos_q, pos_k = _zigzag(1, 2 * Sq, 2), _zigzag(0, 2 * Sk, 2)
    else:
        pos_q = np.arange(Sq, dtype=np.int32)
        # "future": the first half of the query rows see no key at all;
        # "offset": Sk > Sq keys straddle the queries
        pos_k = np.arange(Sk, dtype=np.int32) + {
            "arange": 0, "future": Sq // 2, "offset": (Sq - Sk) // 2}[kind]
    o, lse = flash_attention.flash_attention_fwd_plain(
        _t(q), _t(k), _t(v), _t(pos_q), _t(pos_k), causal=causal,
        window=window)
    delta = np.einsum("bshd,bshd->bhs", do, o.numpy())
    return (q, k, v, do, lse.numpy(), delta.astype(np.float32),
            pos_q.astype(np.int32), pos_k.astype(np.int32))


def _assert_grads(got, want, lse, tol=BWD_TOL):
    """dq, dk, dv within ``tol``; rows with a dead lse give dq = 0 exactly."""
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=tol,
                                   rtol=tol, err_msg=name)
    dead = np.swapaxes(np.asarray(lse) <= NEG_INF / 2, 1, 2)  # (B, Sq, Hq)
    assert (np.asarray(got[0])[dead] == 0.0).all()


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel vs its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("merge", [False, True], ids=["B1", "B2"])
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_flash_fwd_kernel_matches_plain(cuda_device, case, merge, dtype):
    B, S, Hq, Hkv, D, causal, window, kind, _ = FWD_CASES[case]
    if D not in flash_attention.HEAD_DIMS:
        D = 32
    # a ragged edge: Sq, Sk not multiples of the 64-row tile
    S2 = S if kind == "zigzag" else S + 13
    q, k, v, pos_q, pos_k = _fwd_inputs(B, S2, Hq, Hkv, D, kind)
    dt = getattr(torch, dtype)
    args = [_t(x).to(cuda_device, dt) for x in (q, k, v)] + \
        [_t(x).to(cuda_device) for x in (pos_q, pos_k)]
    if merge:
        rng = np.random.default_rng(1)
        o_acc = _t(rng.normal(size=q.shape).astype(np.float32)).to(cuda_device)
        lse_acc = _t(rng.normal(size=(B, Hq, q.shape[1])).astype(
            np.float32)).to(cuda_device)
        lse_acc[:, :, :5] = NEG_INF
        o_acc[:, :5] = 0.0
        args += [o_acc, lse_acc]
    kw = dict(causal=causal, window=window)
    before = dict(flash_attention.LAUNCHES)
    o, lse = flash_attention.flash_attention_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES["B2" if merge else "B1"] == \
        before["B2" if merge else "B1"] + 1
    o_p, lse_p = flash_attention.flash_attention_fwd_plain(*args, **kw)
    tol = 2e-5 if dtype == "float32" else 1e-4
    _assert_partials(o.cpu().numpy(), lse.cpu().numpy(),
                     o_p.cpu().numpy(), lse_p.cpu().numpy(), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_decode_kernel_matches_plain(cuda_device, case, dtype):
    B, Hq, Hkv, D, ps, W, sp, rank, window = PAGED_CASES[case]
    if D not in flash_attention.HEAD_DIMS:
        D = 32
    q, pool_k, pool_v, tbl, cl = _paged_inputs(B, Hq, Hkv, D, ps, W, sp)
    dt = getattr(torch, dtype)
    args = [_t(x).to(cuda_device, dt) for x in (q, pool_k, pool_v)] + \
        [_t(x).to(cuda_device) for x in (tbl, cl)] + [rank]
    kw = dict(sp=sp, page_size=ps, window=window)
    o, lse = paged_decode.paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    o_p, lse_p = paged_decode.paged_decode_attention_plain(*args, **kw)
    tol = 2e-5 if dtype == "float32" else 1e-4
    _assert_partials(o.cpu().numpy(), lse.cpu().numpy(),
                     o_p.cpu().numpy(), lse_p.cpu().numpy(), tol)


@pytest.mark.gpu
def test_kernel_wrappers_raise_on_unsupported_cuda_input(cuda_device):
    q = torch.zeros((1, 8, 2, 48), device=cuda_device)      # head_dim 48
    pos = torch.arange(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention_fwd(q, q, q, pos, pos)


@pytest.mark.gpu
@pytest.mark.parametrize("attention_impl", ["startrail", "local"])
def test_attention_route_launches_its_kernel(cuda_device, attention_impl):
    """At P = 1 the StarTrail route is one ring step through B2 and the
    local route one block through B1; both match full plain attention."""
    from repro_torch.dist.comm import SingleComm
    from repro_torch.kernels import ref
    from repro_torch.models.runtime import Runtime

    S, window = 77, 24
    q, k, v, _, _ = _fwd_inputs(1, S, 8, 2, 80, "arange")
    q, k, v = (_t(x).to(cuda_device) for x in (q, k, v))
    rt = Runtime(comm=SingleComm(), st_cfg=st_torch.StarTrailConfig(
        seq_len=S, seq_scheme="contiguous", window=window,
        block_impl="cuda"), attention_impl=attention_impl,
        device=cuda_device)
    flash_attention.reset_launches()
    o = rt.attention(q, k, v, window=window)
    torch.cuda.synchronize()
    local = attention_impl == "local"
    assert flash_attention.LAUNCHES == {"B1": int(local), "B2": int(not local),
                                        "B3": 0}
    want = ref.mha_reference(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(o.cpu().numpy(), want.cpu().numpy(),
                               atol=TOL, rtol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_kernel_matches_plain(cuda_device, case, dtype):
    B, Sq, Sk, Hq, Hkv, D, causal, window, kind, _ = BWD_CASES[case]
    if D not in flash_attention.HEAD_DIMS:
        D = 32
    if kind != "zigzag":
        # a ragged edge: Sq, Sk not multiples of the 64-row tile
        Sq, Sk = Sq + 13, Sk + 13
    arrs = _bwd_inputs(B, Sq, Sk, Hq, Hkv, D, causal, window, kind)
    dt = getattr(torch, dtype)
    args = [_t(x).to(cuda_device, dt) for x in arrs[:4]] + \
        [_t(x).to(cuda_device) for x in arrs[4:]]
    kw = dict(causal=causal, window=window)
    before = flash_attention.LAUNCHES["B3"]
    got = flash_attention.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES["B3"] == before + 1
    want = flash_attention.flash_attention_bwd_plain(*args, **kw)
    _assert_grads([g.cpu().numpy() for g in got],
                  [w.cpu().numpy() for w in want], arrs[4])
    again = flash_attention.flash_attention_bwd(*args, **kw)
    for a, b in zip(got, again):           # no atomics: the same bits
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_startrail_backward_launches_b3(cuda_device):
    """At P = 1 the autograd backward of ``StarTrailAttention`` is one ring
    step through B3 per call, and equals the explicit functions."""
    from repro_torch.dist.comm import SingleComm

    S, window = 77, 24
    q, k, v, _, _ = _fwd_inputs(1, S, 8, 2, 80, "arange")
    do = torch.randn((1, S, 8, 80), device=cuda_device)
    q, k, v = (_t(x).to(cuda_device).requires_grad_() for x in (q, k, v))
    cfg = st_torch.StarTrailConfig(seq_len=S, seq_scheme="contiguous",
                                   window=window, block_impl="cuda")
    flash_attention.reset_launches()
    o = st_torch.startrail_attention(q, k, v, cfg, SingleComm())
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == {"B1": 0, "B2": 1, "B3": 1}
    with torch.no_grad():
        o2, res = st_torch.startrail_forward(q, k, v, cfg, SingleComm())
        want = st_torch.startrail_backward(res, o2, do, cfg, SingleComm())
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b)
